#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--skip GROUP,...]

Every phase runs by default; ``--skip`` leaves out groups of later phases
that feed nothing else (``SKIPPABLE``), to iterate on one part.

Phases, each a plain function that the CPU tests also call at a tiny size:

1. card: the device's name and count, and nvidia-smi's name and power limit;
2. build: compile every CUDA source of the paths, print each Gram
   instance's ptxas line (registers, spills) and its count of HGMMA (wgmma)
   instructions in the built library, and fail on a spill or on no HGMMA;
3. kernels: the four Gram instances (fused and symmetric, each with the
   split's three bf16 products and with one bf16 pass): print each one's
   schedule at its main shape, hold it against its plain PyTorch version on
   the card at the shapes its main path gives it, the north-star width, a
   main-path row count at 129 columns (the plain-load route, where TMA
   cannot go) and a ragged shape, then time kernel, plain version and a
   library yardstick with CUDA events;
4. main path (resident): fit PCA (500,000 x 512, k=50, precision "high",
   8 partitions) through fused_gram_moments, check it against the f64 host
   oracle and a "highest" fit, transform every row and check the projection;
5. solvers: the resident fit with solvers "svd", "randomized" and "auto"
   ("auto" must be the randomized fit, bit for bit), each gated against an
   f64 reference, and the decomposition stage timed alone per solver;
6. one pass (resident): the resident fit at precision "default" through
   the fused one-product instance (its Gram's own diagonal Σhi²), against
   the f64 oracle;
7. standardize: fit the resident shape with standardize=True and check it
   against the f64 eigenvectors of the standardized scatter;
8. main path (streamed): fit PCA on BASELINE config 2 whole (10,000,000 x
   512, k=50, "high", 20 partitions), which streams above the resident
   cutover through symmetric_gram_moments, and check it against an f64
   oracle, a streamed "highest" fit, its device memory and its overlap;
9. one pass (streamed): the same data at "default" through the symmetric
   one-product instance, and its first 1,000,000 rows at "highest" under
   TPU_ML_PRECISION_POLICY=bf16_f32acc, both against their f64 oracles;
10. serving: phase 4's model (pca512), phase 7's standardized model and
   pca512's bf16_f32acc variant (picked through a tuning-cache file)
   registered over the whole bucket ladder, one CUDA graph per rung; each
   rung's replay held bit for bit against an eager projection of the same
   padded block (and the model's transform at that bucket) and timed
   against it; then the HTTP server with a UDS socket: 1,000 sequential
   one-row requests on each of four wires (in-process client, HTTP binary,
   UDS JSON, fast lane), 4,000 mixed requests (1 to 4,096 rows,
   log-uniform) from 16 threads over HTTP binary and the fast lane, 300
   one-row requests direct and through a batcher alone (with the configured
   window and with none), and 200
   requests alternating between two models under an HBM budget that holds
   one, so that they page. Every answer is checked against the eager
   transform and the f64 projection; so are the capture, JSON-codec,
   coalescing and paging counters. Beside them: phase 11's StandardScaler
   model registered over the whole ladder (each rung's replay bit for bit
   the eager standardize of its block, every answer within the f64 bound);
   the exporter and the health monitor (/healthz, /slo, /report, which
   holds phase 11's fits); and an objective that cannot be met, under
   which one-row requests get HTTP 503 with TPU_ML_ADMISSION_POLICY=refuse
   and never with off;
11. BASELINE config 4 (resident, before phase 10): Pipeline([StandardScaler
   (withMean, withStd), PCA(k=50, "high")]) on phase 4's 500,000 x 512 rows
   in 8 partitions, fused_gram_moments launched 8 times in the fit, its
   components held to the f64 eigenvectors of the standardized scatter and
   to phase 7's model, every row transformed and held to the f64 pipeline;
   the same with Normalizer(p=2) against the f64 scatter of the normalized
   rows; each FitReport printed and gated (rows, peak device memory, wall
   time); and, on phase 8's 10,000,000 x 512 data before it is freed, a
   streamed StandardScaler fit (the moments fold, no Gram kernel) held to
   f64 moments;
12. BASELINE config 5 (after phase 8's data is freed): KMeans (k=1000,
   k-means++, maxIter=20, tol=1e-4) on 50,000,000 x 128 f32 blobs (1,000
   seeded centres, unit noise) made on the card, in 12 partitions that the
   fit pads to 2^22 rows on the card; the fit's wall time, its "kmeans
   init"/"kmeans lloyd" spans, iterations, seconds per Lloyd iteration
   against the step's f32 bound, h2d_bytes and peak device memory; a second
   fit with initMode="k-means||"; one Lloyd step from the fit's initial
   centres against f64 (labels equal but for near ties, counts, sums and
   cost within 1e-5), timed at the 8,192-row block and the card's; one pass
   each under TPU_ML_PRECISION_POLICY=int8_dist and bf16_f32acc (time and
   label agreement with f32); trainingCost against the f64 cost of the
   centres it was computed from; transform of all 50,000,000 rows against
   the f64 argmin of the fitted centres. No hand kernel runs here: the
   distances and sums are cuBLAS products (int8_dist: torch._int_mm);
13. DBSCAN on 100,000 x 128 rows (grids of unit-spaced points on random
   planes, a tenth moved off as noise), eps^2 = 1.5 far from every pairwise
   distance, minSamples=5: labels exactly those of an f64 oracle (the eps
   graph in f64 on the card, scipy's connected components of the core
   points, the smallest-core-neighbour border rule); exact
   NearestNeighbors(k=10) over a 1,000,000 x 128 corpus with 10,000
   queries against an f64 brute force on the card (ids within the f64
   top 10 up to near ties, distances rtol 1e-5), and the int8_dist
   product's recall@10;
14. the linear family, in four places: (d), after phase 7, on phase 4's
   500,000 x 512 rows: TruncatedSVD (k=50) and IncrementalPCA over 8
   batches at "highest" and "high", fused_gram_moments launched once a
   partition and symmetric_gram_moments once a batch at "high" (none at
   "highest"), components against the f64 oracle (min |cosine| >= 0.9999)
   and IncrementalPCA against the one-shot fit; IncrementalLinearRegression
   over 10 batches against the one-shot fit (both held to the f64 normal
   equations by the bound of their own f32 statistics); IncrementalKMeans
   mini-batch steps (10 batches of 100,000 x 128 blobs, k=100) against f64
   updates. (a), before phase 8's data is freed: LinearRegression streamed
   over its 10,000,000 x 512 rows with a seeded label, plain, weighted and
   elastic net, h2d_bytes exactly rows x (n + 2) x 4, each fit's own
   statistics refolded and held to f64 statistics on the card (XᵀX within
   1e-5) and its coefficients to the f64 oracle within the perturbation
   bound those statistics give (elastic net: its optimality conditions),
   the same fold into an f32 carry beside it, the fold's share of the fit
   and the card's idle share. (e) (a)'s model served: a CUDA graph per
   rung bit for bit the eager margin, a one-row fast-lane request, f64
   gates. (b) binary LogisticRegression and LinearSVC (regParam 0.01) on
   the first 5,000,000 rows resident in 8 partitions, a logistic fit killed
   in its third iteration and resumed from its checkpoint (equal to the
   uninterrupted fit); (c) multinomial LogisticRegression, 10 classes, on
   the first 1,000,000 rows (55 block products an iteration): each held to
   f64 passes on the card (the gradient at the fit within 1e-4 of its value
   at zero, the objective within 1e-6 of an f64 Newton's), with
   iterations, seconds per iteration and the per-iteration bound.

15. approximate nearest neighbours (no hand kernel: the IVF scan is gathers
   and cuBLAS products): (a) ApproximateNearestNeighbors (nlist auto, 1,000;
   maxIter 10) on phase 13's 1,000,000 x 128 corpus, the build by span
   (quantizer, assign, pack), the first 1,024 of its 10,000 queries at
   nprobe == nlist held to the f64 top 10 (phase 13's near-tie rule,
   distances rtol 1e-5), recall@10 at nprobe 20 beside the JAX test's floor
   of 0.9; (c) that index served, a CUDA graph per rung bit for bit the
   eager search, 200 one-row queries each over HTTP /v1/indexes/ann:query,
   UDS and the fast lane, every answer the eager one and ann.queries
   counting each; (b) IVFFlatIndex streamed over a SIFT-10M-shaped corpus
   (10,000,000 x 128 seeded clustered rows in ten host chunks): each pass
   timed, cap, spill fraction, index bytes, the streamed pack bit for bit
   build_ivf_buckets of the whole corpus from the same centroids, recall@10
   at nprobe 1, 8, 20 and 64 (non-decreasing) against the port's exact
   NearestNeighbors over the same rows, with queries/s and one-row latency;
16. trees and NaiveBayes on HIGGS-shaped rows (11,000,000 x 28, the last
   500,000 held out): (a) RandomForestClassifier and (b)
   RandomForestRegressor at Spark's defaults (20 trees, depth 5, 32 bins,
   "auto" features, Poisson bootstrap), fit time, time per level, held-out
   quality, every split's gain recomputed in f64 from its node's rows
   within the stated near-tie bound of the f64 best; (c)
   DecisionTreeClassifier (all features) on 200,000 rows bit for bit its
   CPU build; (d) (a)'s forest served, each rung's replay bit for bit the
   eager descent; (e) gaussian NaiveBayes on the HIGGS rows and (f)
   multinomial on 2,000,000 x 1,024 Poisson counts in 20 classes,
   statistics within 1e-5 of f64 and predictions equal up to near ties;
17. families (no hand kernel: the forest's histograms, cuBLAS products,
   autograd, gathers and index_add_): (a) GBTClassifier and GBTRegressor
   at Spark's defaults (20 stages, depth 5, 32 bins, stepSize 0.1) on
   phase 16's HIGGS-shaped rows, every split of stages 1, 2 and 20 within
   its near-tie bound of the f64 best (each stage's residuals from the f64
   ensemble of the card's earlier trees), the card's final F within 1e-5
   of the f64 ensemble, the regressor's loss never rising beyond rounding,
   and the serving registry refusing both models; (c) FMClassifier and
   FMRegressor (factorSize 8, adamW, stepSize 0.01, 100 iterations) on the
   same rows, held-out scores within 1e-5 of f64, trainLoss within 1e-5 of
   the f64 loss at the returned weights, the losses of the first 10 steps
   on 1,000,000 rows within 1e-4 of the same steps in f64 on the CPU, one
   iteration profiled by operator; (b) MultilayerPerceptronClassifier
   784-300-100-10 (l-bfgs, 100 iterations) on 60,000 of 70,000
   MNIST-shaped rows (a seeded 10-class Gaussian mixture), trainLoss
   within 1e-5 of f64 and the first 5 iterations' losses within 1e-4 of
   the CPU's f64 run; (d) UMAP at its defaults (15 neighbours, 200
   epochs, spectral init) on those 60,000 rows and a transform of the
   other 10,000, the graph's ids on 2,000 rows in the f64 top 15 (phase
   13's near-tie rule), each row's calibrated mass within 1e-4 of
   log2(15), one layout epoch within 1e-4·max|y| of the CPU's f64 epoch
   on the same negatives, trustworthiness@15 and the held-out 15-NN label
   vote printed, and whether two same-seed layouts are bit-equal (with
   and without torch's deterministic algorithms); (e)
   OneVsRest(LogisticRegression()) on the same rows, every held-out
   prediction the f64 argmax of the class models' scores up to near ties;
18. model selection and recovery (no new kernel), in three places: (d),
   after phase 14 (d), phase 4's resident fit with one task failing once
   (retried: fused_gram_moments still 8 launches) and one hanging past
   TPU_ML_HEDGE_FLOOR_S (hedged once: 9 launches), pc bit-equal to the clean
   fit's; (c), before phase 8's data is freed, its streamed fold under fault
   plans (a preemption and a resume from checkpoints every 16 chunks,
   transient faults at ingest.chunk and fold.dispatch, a device OOM that
   bisects to 32,768-row chunks, a hang of fold.wait inside its bound and
   one past it), each held to one clean run (bit-equal, or the f64 oracle
   and explainedVariance within 1e-4 after a bisection) with the kernel's
   launches and the recovery counters; (a), (b), (e), after phase 17:
   Tokenizer → HashingTF(2^13) → IDF over a 20 Newsgroups-shaped corpus
   (18,846 documents, 20 classes, 280 tokens, a 50,000-term Zipf
   vocabulary) and CrossValidator over multinomial NaiveBayes's smoothing
   (TF against hashlib + Counter, IDF against numpy, fold predictions
   against f64 fits but for near ties); UCI Adult's schema at 1,000,000
   rows through 8 StringIndexers, 8 OneHotEncoders and a VectorAssembler
   (100 columns, against numpy's one-hot), CrossValidator over
   LogisticRegression (AUC) and TrainValidationSplit over LinearRegression
   (RMSE, the FISTA path), each candidate within 1e-4 of f64 fits, then
   IndexToString; and the device policy: a bounded probe, the health
   monitor's subprocess probe, and a device.init fault read by its
   transport component;
19. cost model, autotune, partition bodies (no new kernel), in three
   places: (a), after phase 4, one resident "high" fit of its 500,000 x 512
   rows in 8 partitions and a transform, read through the analytical cost
   model: linalg.gram_stats booked once a partition and equal to the
   fused_gram_moments launches, each call's flops the formula at the padded
   65,536-row partition, the roofline share in (0, 1.05], the transform's
   report holding linalg.project; (c), after (a), the Spark glue's
   FitPartitionFn.partition_stats over the same 8 partitions (two frames of
   named columns each, one fused_gram_moments launch a frame), merged in
   f64 on the host as the driver merges them and decomposed on the card
   against the f64 oracle, and TransformPartitionFn's array body over every
   row against (a)'s transform (1e-5 of max |value|); (b), before phase 8's
   data is freed, BASELINE config 2 fitted under TPU_ML_AUTOTUNE=search (a
   tuning-cache file in a fresh temporary directory): the successive
   halving's trials within the budget, each folding synthetic chunks
   through symmetric_gram_moments twice, the fit folding
   ceil(10,000,000 / winner) chunks and meeting the f64 oracle; then again
   under TPU_ML_AUTOTUNE=cache, a hit of the same chunk rows whose pc is bit
   for bit the searched fit's; each candidate's seconds per row printed;
20. the Spark glue's device half (no new kernel): each partition body of
   the Spark estimators over 8 partitions of 2 frames of named columns (no
   pyarrow), the statistics merged in f64 on the host as the driver merges
   them, then each estimator's own driver half on the card, in three
   places: (c), (d) after phase 19 (c), on phase 4's 500,000 x 512 rows:
   the moments (SparkStandardScaler's moments_merged), range and 4,096-bin
   histogram (SparkRobustScaler's robust_merged: medians within one bin
   of the exact ones) bodies, the NaN-aware moments and range on the same
   rows with a seeded 1% NaN (SparkImputer's surrogate), each against f64
   at 1e-5 or exactly, and SparkTruncatedSVD's FitPartitionFn at "high"
   (16 fused_gram_moments launches, counted in the kernels line as
   phase20_launches) and decompose_merged against the f64 oracle; (a), (d)
   after phase 14 (b, c), on the first 1,000,000 of phase 8's rows (phase
   14's labels, weights and classes): LinRegPartitionFn (SparkLinearRegression's
   solve_merged, held by phase 14's perturbation bound), 3 binary and 3
   10-class Newton jobs (SparkLogisticRegression's newton_step; the first
   job's gradient against f64, the parameters against the core estimator's
   3 iterations on the same rows); (b), (d) after phase 12, on 2,000,000 of
   config 5's 128-wide blobs with k = 1,000: one k-means‖ round (the cost
   and sample bodies; each trial against the f64 rule but for near ties),
   the weighting body on the candidates, SparkKMeans' reduce_candidates and
   3 Lloyd jobs (lloyd_step), each merge against an f64 pass with phase
   12's near-tie rule; and the transform bodies (MatrixMap for
   StandardScaler and LinearRegression, ProbaPrediction for binary
   logistic, MultiOutput for KMeans) against the models' own transforms.
21. the mesh (no new kernel; group "mesh"), before phase 8's data is
   freed: (a) 2,000,000 x 512 rows in four data shards of the card at
   "high": sharded_gram_stats (4 fused_gram_moments launches) against the
   one-device Gram (1e-5 x max) and f64 (3e-5), distributed_pca_fit (k=50)
   and the ring Gram at data = feat = 2 against f64, moments, ranges and a
   histogram against f64 or exactly; (b) phase 8's 10,000,000 x 512 rows
   through the per-shard chunk fold on the mesh-local fit's own mesh (one
   card) and on four shards of it (153 and 612 symmetric_gram_moments
   launches), against the one-device fold (1e-5 x max) and the f64 oracle,
   degraded.cpu_fallback 0; (c) distributed_pca_fit_svd over four shards
   and the sketched fit (data = feat = 2, l = 70) on 1,000,000 of (a)'s
   rows against f64; (d) MeshGramPartitionFn and MeshSVDFitFn in four
   spawned processes on cuda:0 over gloo, their rendezvous on a TCPStore,
   on 8 frames of phase 4's rows: only rank 0 yields, its rows against the
   in-process mesh program and f64. The kernels line gains
   phase21_launches.
22. the mesh fits (no new kernel; group "meshfit"), each part in four data
   shards of the card beside the data of the phase it follows: (a) after
   phase 21, phase 14's labels and weights: sharded_linear_stats_weighted
   on 2,000,000 of phase 8's rows against one device and, through phase
   14's perturbation bound, f64; config 2 whole through the per-shard
   linear fold with the streamed intercept column against phase 14's
   one-device carry; (b) the whole-loop binary logistic and squared-hinge
   fits on 1,000,000 rows against the core estimators, 3 iterations of the
   10-class softmax against the core fit's, a chunked fit killed after one
   chunk and resumed bit-equal; (g) MeshLinRegPartitionFn,
   MeshLogRegFitFn, MeshSoftmaxFitFn (3 classes) and MeshKMeansFitFn in one
   spawn of four processes over gloo, only rank 0 yielding, against the
   in-process programs and f64; (c) after phase 12, one mesh k-means‖
   round and 5 Lloyd steps on 2,000,000 of config 5's blobs (k = 1,000)
   against one device and f64 under phase 12's near-tie rule, the whole
   loop and a chunked resume bit-equal; (d) after phase 13, the sharded
   DBSCAN on 40,000 lattice rows (labels equal to one device's) and the
   sharded kNN over the 1,000,000-row corpus (4,096 queries) against one
   device and f64; (f) after phase 15, one streamed Lloyd pass of the IVF
   index's mesh fold over 2,000,000 SIFT-shaped rows against the
   one-device fold; (e) after phase 16, a forest through the mesh builder
   on 1,000,000 HIGGS-shaped rows equal to the one-device build, and the
   sharded NaiveBayes statistics on 500,000 count rows. The kernels line
   gains phase22_launches.

Each main path reads the kernels' launch counts from 0 around exactly its
fit. The last lines are one JSON object with every kernel's numbers, the
card's nvidia-smi line, and {"ok": true, "device": {...}}. Without a card the
script exits nonzero and prints no result. Every failed check raises.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import functools
import hashlib
import http.client
import json
import os
import re
import shutil
import socket
import subprocess
import tempfile
import threading
from pathlib import Path
import sys
import time

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import (
    DBSCAN, IDF, PCA, UMAP, ApproximateNearestNeighbors, BinaryClassificationEvaluator,
    CrossValidator, DecisionTreeClassifier, FMClassifier, FMRegressor, GBTClassifier,
    GBTRegressor, HashingTF, IncrementalKMeans, IncrementalLinearRegression, IncrementalPCA,
    IndexToString, KMeans, LinearRegression, LinearSVC, LogisticRegression,
    MulticlassClassificationEvaluator, MultilayerPerceptronClassifier, NaiveBayes,
    NaiveBayesModel, NearestNeighbors, Normalizer, OneHotEncoder, OneVsRest, ParamGridBuilder,
    Pipeline, RandomForestClassifier, RandomForestRegressor, RegressionEvaluator,
    StandardScaler, StringIndexer, Tokenizer, TrainValidationSplit, TruncatedSVD,
    VectorAssembler,
)
from spark_rapids_ml_tpu_torch.ann.serving import unpack_query_result
from spark_rapids_ml_tpu_torch.ops import _build
from spark_rapids_ml_tpu_torch.models import fm as PFM
from spark_rapids_ml_tpu_torch.models import forest as PF
from spark_rapids_ml_tpu_torch.models import mlp as PMLP
from spark_rapids_ml_tpu_torch.models import umap as PUMAP
from spark_rapids_ml_tpu_torch.ops import dbscan as DB
from spark_rapids_ml_tpu_torch.ops import forest as FO
from spark_rapids_ml_tpu_torch.ops import gram_moments as G
from spark_rapids_ml_tpu_torch.ops import kmeans as KM
from spark_rapids_ml_tpu_torch.ops import linalg as L
from spark_rapids_ml_tpu_torch.ops import linear as LIN
from spark_rapids_ml_tpu_torch.ops import naive_bayes as NBO
from spark_rapids_ml_tpu_torch.ops import neighbors as NN
from spark_rapids_ml_tpu_torch.ops import optim as OPT
from spark_rapids_ml_tpu_torch.ops import scaler as SCL
from spark_rapids_ml_tpu_torch.ops import umap as UMO
from spark_rapids_ml_tpu_torch import autotune
from spark_rapids_ml_tpu_torch.autotune import cache as tuning_cache
from spark_rapids_ml_tpu_torch.autotune.policy import TuningConfig, resolve_policy
from spark_rapids_ml_tpu_torch.parallel import dbscan as MPD
from spark_rapids_ml_tpu_torch.parallel import gram as MG
from spark_rapids_ml_tpu_torch.parallel import kmeans as MPK
from spark_rapids_ml_tpu_torch.parallel import linear as MPL
from spark_rapids_ml_tpu_torch.parallel import mesh as MM
from spark_rapids_ml_tpu_torch.parallel import naive_bayes as MPNB
from spark_rapids_ml_tpu_torch.parallel import neighbors as MPN
from spark_rapids_ml_tpu_torch.parallel import sketched as MSK
from spark_rapids_ml_tpu_torch.parallel import tsqr as MT
from spark_rapids_ml_tpu_torch.parallel.tree_aggregate import tree_reduce
from spark_rapids_ml_tpu_torch.resilience import faults
from spark_rapids_ml_tpu_torch.resilience.retry import FoldHangTimeout
from spark_rapids_ml_tpu_torch.serving import buckets as B
from spark_rapids_ml_tpu_torch.serving import client as serve_client
from spark_rapids_ml_tpu_torch.serving import fastlane as FL
from spark_rapids_ml_tpu_torch.serving import hbm
from spark_rapids_ml_tpu_torch.serving import registry as R
from spark_rapids_ml_tpu_torch.serving import server as S
from spark_rapids_ml_tpu_torch.serving.batcher import MicroBatcher
from spark_rapids_ml_tpu_torch.spark import arrow_fns, ingest, spmd
from spark_rapids_ml_tpu_torch.spark import estimators as spark_est
from spark_rapids_ml_tpu_torch.telemetry import health, httpd, slo
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.telemetry.timeline import TIMELINE
from spark_rapids_ml_tpu_torch.utils import columnar, devicepolicy
from spark_rapids_ml_tpu_torch.utils.checkpoint import TrainingCheckpointer
from spark_rapids_ml_tpu_torch.utils.device import block_rows_for, to_device

# H100 SXM published dense peaks (NVIDIA data sheet), at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

MAIN_SHAPE = (65_536, 512)  # one partition of the resident fit, padded
MAIN_ROWS, MAIN_N, MAIN_K, MAIN_PARTITIONS = 500_000, 512, 50, 8
# BASELINE config 2 whole: 152 chunks of 65,536 rows and a 38,528-row tail
STREAM_ROWS, STREAM_PARTITIONS = 10_000_000, 20
STREAM_SHAPE = (65_536, 512)
STREAM_TAIL_SHAPE = (STREAM_ROWS % 65_536, 512)
STREAM_BISECTED_SHAPE = (65_536 // 2, 512)  # phase 18 (c)'s chunks after an OOM bisection
STREAM_PEAK_BYTES = 1 << 30  # O(chunk + n²) device memory for 20.5 GB of input
TIMED_LAUNCHES = 20
COSINE_BAR = 0.9999

_GRAM_SOURCE = "spark_rapids_ml_tpu_torch/csrc/gram_moments.cu"
KERNELS = {
    "gram_moments": {
        "route": "cuda",
        "source": _GRAM_SOURCE,
        "replaces": "spark_rapids_ml_tpu/ops/pallas_gram.py:199",
    },
    "symmetric_gram_moments": {
        "route": "cuda",
        "source": _GRAM_SOURCE,
        "replaces": "spark_rapids_ml_tpu/ops/pallas_gram.py:144",
    },
    # no Pallas kernel: the one-bf16-pass Gram the JAX package leaves to
    # XLA (policy_matmul's bf16_f32acc, and Precision.DEFAULT's)
    "gram_moments_1pass": {
        "route": "cuda",
        "source": _GRAM_SOURCE,
        "replaces": "spark_rapids_ml_tpu/ops/linalg.py:65",
    },
    "symmetric_gram_moments_1pass": {
        "route": "cuda",
        "source": _GRAM_SOURCE,
        "replaces": "spark_rapids_ml_tpu/ops/linalg.py:65",
    },
}
# each kernel's count of products and whether it is the symmetric kernel
PRODUCTS = {"gram_moments": 3, "symmetric_gram_moments": 3,
            "gram_moments_1pass": 1, "symmetric_gram_moments_1pass": 1}
SYMMETRIC = {"symmetric_gram_moments", "symmetric_gram_moments_1pass"}
# wrapper and plain version of each kernel
FUNCTIONS = {
    name: (
        functools.partial(
            G.symmetric_gram_moments if name in SYMMETRIC else G.fused_gram_moments,
            products=PRODUCTS[name],
        ),
        functools.partial(
            G.symmetric_gram_moments_reference if name in SYMMETRIC
            else G.fused_gram_moments_reference,
            products=PRODUCTS[name],
        ),
    )
    for name in KERNELS
}
# the shape each kernel's main path gives it comes first
_FUSED_SHAPES = (MAIN_SHAPE, (131_072, 2_048), (65_536, 129), (1_000, 300))
_SYMMETRIC_SHAPES = (
    STREAM_SHAPE, STREAM_TAIL_SHAPE, STREAM_BISECTED_SHAPE, (131_072, 2_048), (65_536, 129),
    (1_000, 300),
)
KERNEL_SHAPES = {
    name: _SYMMETRIC_SHAPES if name in SYMMETRIC else _FUSED_SHAPES for name in KERNELS
}
# the Gram kernel instance of each kernel in the built library: its mangled
# name holds gram_partial_kernel<symmetric, products>
INSTANCES = {
    name: f"gram_partial_kernelILb{int(name in SYMMETRIC)}ELi{PRODUCTS[name]}E"
    for name in KERNELS
}
# each kernel's launch counter in ops/gram_moments.py
COUNTERS = {
    "gram_moments": "launches",
    "symmetric_gram_moments": "symmetric_launches",
    "gram_moments_1pass": "launches_1pass",
    "symmetric_gram_moments_1pass": "symmetric_launches_1pass",
}


def reset_launches() -> None:
    for counter in COUNTERS.values():
        setattr(G, counter, 0)


def read_launches() -> dict:
    return {name: getattr(G, counter) for name, counter in COUNTERS.items()}


def expected_launches(**counts: int) -> dict:
    """Every kernel's launch count: those named, the others 0."""
    return {name: counts.get(name, 0) for name in KERNELS}


@functools.lru_cache(maxsize=1)
def bench_workload(rows: int, n: int, seed: int = 7) -> np.ndarray:
    """The bench's correlated-spectrum data: a rank-64 mix plus 0.1 noise,
    f32. Its eigenvalues are well separated, so components compare. The
    last one made is kept, so the resident phases share it (read only)."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(rows, 64)).astype(np.float32)
    mix = rng.normal(size=(64, n)).astype(np.float32)
    return base @ mix + 0.1 * rng.normal(size=(rows, n)).astype(np.float32)


def gram_bound(rows: int, n: int, products: int = 3) -> tuple[float, str]:
    """Least time (ms) an H100 needs for the kernel's work, and what bounds
    it. The Gram is symmetric: its least work is the upper triangle of hiᵀhi,
    rows·n·(n+1) bf16 operations, and with three products all of hiᵀlo too
    (loᵀhi is its transpose), 2·rows·n² more: rows·n·(n+1) +
    (products − 1)·rows·n² in all, against X read once and the three outputs
    written once. The fused and symmetric kernels of one count of products
    compute that same function."""
    ops_ms = float(rows) * n * (n + 1 + (products - 1) * n) / PEAK_BF16_FLOPS * 1e3
    bytes_ms = 4.0 * (rows * n + n * n + 2 * n) / PEAK_HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def phase_card() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = {
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
    }
    print(f"card: {card['kind']} x{card['count']} | nvidia-smi: {smi}", flush=True)
    return card


@functools.lru_cache(maxsize=None)
def card_label(device_type: str) -> str:
    """nvidia-smi's name and power limit of the card, or "cpu"."""
    if device_type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def build_report(log: str, sass: str) -> dict:
    """Each Gram instance's ptxas lines (from ``-Xptxas -v``'s log), its
    spill bytes, and its count of HGMMA instructions in ``cuobjdump -sass``'s
    listing of the built library."""
    report = {}
    for kernel, mangled in INSTANCES.items():
        ptxas, current = [], False
        for line in log.splitlines():
            if "Compiling entry function" in line:
                current = mangled in line
            elif current and ("Used" in line or "spill" in line):
                ptxas.append(line.strip())
        hgmma, current = 0, False
        for line in sass.splitlines():
            if "Function :" in line:
                current = mangled in line
            elif current and "HGMMA" in line:
                hgmma += 1
        spills = sum(
            int(b) for line in ptxas for b in re.findall(r"(\d+) bytes spill", line)
        )
        report[kernel] = {"ptxas": ptxas, "spill_bytes": spills, "hgmma": hgmma}
    return report


def phase_build() -> dict:
    sources = sorted({Path(meta["source"]).stem for meta in KERNELS.values()})
    t0 = time.perf_counter()
    logs = _build.build(sources)
    print(f"build: {sources} in {time.perf_counter() - t0:.1f} s", flush=True)
    cuobjdump = shutil.which("cuobjdump") or str(Path(_build._nvcc()).parent / "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "-sass", str(_build.library_path("gram_moments"))],
        capture_output=True, text=True, check=True, timeout=300,
    ).stdout
    report = build_report(logs["gram_moments"], sass)
    for kernel, entry in report.items():
        for line in entry["ptxas"]:
            print(f"build: {kernel}: {line}", flush=True)
        print(f"build: {kernel}: {entry['hgmma']} HGMMA instructions", flush=True)
        if not entry["ptxas"] or entry["spill_bytes"] or not entry["hgmma"] > 0:
            raise AssertionError(f"{kernel}: no ptxas line, a spill or no HGMMA: {entry}")
    return report


def schedule_summary(rows: int, n: int, symmetric: bool, sm_count: int) -> dict:
    """The kernel's work list at one shape: items, blocks, items and row
    steps per block (SM)."""
    plan = G.schedule(rows, n, symmetric, sm_count)
    per_block = np.diff(plan.block_items)
    steps = plan.steps_per_block()
    return {
        "shape": [rows, n], "tiles": len(plan.tiles), "items": len(plan.items),
        "blocks": plan.blocks, "sm_count": sm_count,
        "items_per_sm": [int(per_block.min()), int(per_block.max())],
        "steps_per_sm": [min(steps), max(steps)],
    }


def _exact_split_gram(x: torch.Tensor, products: int = 3) -> torch.Tensor:
    """hiᵀhi + hiᵀlo + loᵀhi (or hiᵀhi alone, with one product) summed in
    f64: the kernel's gram without the f32 summation error either side
    carries."""
    hi = x.to(torch.bfloat16)
    hd = hi.double()
    if products == 1:
        return hd.T @ hd
    ld = (x - hi.float()).to(torch.bfloat16).double()
    return hd.T @ hd + hd.T @ ld + ld.T @ hd


def _mirrored_tiles_equal(g: torch.Tensor) -> bool:
    """Every strict-lower TILE block bit-equal to its upper mirror's
    transpose."""
    tile = torch.arange(g.shape[0], device=g.device) // G.TILE
    lower = tile[:, None] > tile[None, :]
    return torch.equal(g[lower], g.T[lower])


def phase_kernel_check(
    shapes, device: torch.device, seed: int = 0, kernel: str = "gram_moments"
) -> dict:
    """Kernel (through its wrapper) against its plain version on the same
    inputs. Both sides form exact bf16×bf16 products, so they differ only in
    the f32 summation order: gram within 1e-5·max|G|, moments within
    rtol 1e-5 and 1e-5·√rows·max|x|. The kernel's gram is also held to the
    same 1e-5·max|G| against the split summed in f64, and a second call must
    give bit-equal results (fixed summation order, no atomics); the
    symmetric kernel's mirrored tiles must be bit-equal."""
    wrapper, plain = FUNCTIONS[kernel]
    gen = torch.Generator(device=device).manual_seed(seed)
    results = {}
    for rows, n in shapes:
        x = torch.randn((rows, n), generator=gen, device=device, dtype=torch.float32)
        g, cs, sq = wrapper(x)
        again = wrapper(x)
        rg, rcs, rsq = plain(x)
        exact = _exact_split_gram(x, PRODUCTS[kernel])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        gram_err = (g - rg).abs().max().item()
        gram_tol = 1e-5 * rg.abs().max().item()
        exact_err = (g.double() - exact).abs().max().item()
        plain_exact_err = (rg.double() - exact).abs().max().item()
        mom_atol = 1e-5 * rows ** 0.5 * x.abs().max().item()
        mom_excess = max(
            ((a - b).abs() - (mom_atol + 1e-5 * b.abs())).max().item()
            for a, b in ((cs, rcs), (sq, rsq))
        )
        entry = {
            "shape": [rows, n],
            "route": G.load_route(x),
            "max_abs_err": gram_err,
            "tol": gram_tol,
            "max_abs_err_vs_f64": exact_err,
            "plain_max_abs_err_vs_f64": plain_exact_err,
            "moments_max_abs_err": max(
                (cs - rcs).abs().max().item(), (sq - rsq).abs().max().item()
            ),
            "moments_atol": mom_atol,
            "repeat_bit_equal": all(torch.equal(a, b) for a, b in zip((g, cs, sq), again)),
        }
        if kernel in SYMMETRIC:
            entry["mirror_bit_equal"] = _mirrored_tiles_equal(g)
        print(f"kernel check: {kernel} {rows}x{n}: {json.dumps(entry)}", flush=True)
        if not (gram_err <= gram_tol and exact_err <= gram_tol and mom_excess <= 0.0):
            raise AssertionError(f"{kernel} disagrees with its plain version: {entry}")
        if not (entry["repeat_bit_equal"] and entry.get("mirror_bit_equal", True)):
            raise AssertionError(f"{kernel} is not bit-equal where it must be: {entry}")
        results[(rows, n)] = entry
        del x, g, cs, sq, again, rg, rcs, rsq, exact
    return results


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel_timing(
    shapes, device: torch.device, seed: int = 1, kernel: str = "gram_moments"
) -> dict:
    """kernel_ms, plain_ms and library_ms over TIMED_LAUNCHES launches after a
    warm-up. The library yardstick, which the port never calls, is cuBLAS's
    f32 ``x.T @ x`` for the three-product kernels and its bf16 ``hi.T @ hi``
    (hi = bf16(x), made before the timing) for the one-product ones."""
    wrapper, plain = FUNCTIONS[kernel]
    products = PRODUCTS[kernel]
    gen = torch.Generator(device=device).manual_seed(seed)
    results = {}
    for rows, n in shapes:
        x = torch.randn((rows, n), generator=gen, device=device, dtype=torch.float32)
        lib_in = x if products == 3 else x.to(torch.bfloat16)
        bound_ms, bound_by = gram_bound(rows, n, products)
        entry = {
            "kernel_ms": _time_ms(lambda: wrapper(x), TIMED_LAUNCHES),
            "plain_ms": _time_ms(lambda: plain(x), TIMED_LAUNCHES),
            "library_ms": _time_ms(lambda: lib_in.T @ lib_in, TIMED_LAUNCHES),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        }
        print(f"kernel timing: {kernel} {rows}x{n}: {json.dumps(entry)}", flush=True)
        results[(rows, n)] = entry
        del x, lib_in
    return results


def _min_abs_cosine(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    cos = np.abs((a * b).sum(0)) / (np.linalg.norm(a, axis=0) * np.linalg.norm(b, axis=0))
    return float(cos.min())


def oracle_from_scatter(scatter: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(components [n, k], explainedVariance [k]) of an f64 scatter matrix
    by the reference's definitions: eigenvectors in descending eigenvalue
    order, and sᵢ/Σs over the full spectrum with s = √λ."""
    evals, evecs = np.linalg.eigh(np.asarray(scatter, dtype=np.float64))
    s = np.sqrt(np.clip(evals[::-1], 0.0, None))
    return evecs[:, ::-1][:, :k], s[:k] / s.sum()


def explained_variance_f64(x: np.ndarray, k: int) -> np.ndarray:
    """The reference's explainedVariance of the uncentered scatter, computed
    in f64 on the host."""
    xa = np.asarray(x, dtype=np.float64)
    return oracle_from_scatter(xa.T @ xa, k)[1]


def explained_variance_high_with_lolo(
    x: np.ndarray, k: int, partitions: int, device: torch.device
) -> np.ndarray:
    """explainedVariance of the "high" fit's path with the off-diagonal part
    of the dropped loᵀlo term added back to each partition's Gram (its
    diagonal already holds Σ(hi + lo)², which has no one-sided drop): the fit
    at "high" differs from it in that term alone."""
    total = None
    for part in np.array_split(x, partitions):
        padded, _ = columnar.pad_rows(part)
        xt = torch.from_numpy(padded).to(device)
        stats = L.gram_stats(xt, precision="high")
        hi = xt.to(torch.bfloat16)
        lo = (xt - hi.float()).to(torch.bfloat16).float()
        lolo = lo.T @ lo
        lolo.diagonal().zero_()
        stats = L.GramStats(stats.xtx + lolo, stats.col_sum, stats.count)
        total = stats if total is None else L.combine_gram_stats(total, stats)
    cov = L.covariance_from_stats(total, mean_centering=False)
    return L.pca_fit_from_cov(cov, k)[1].cpu().numpy()


def phase_main_path(rows: int, n: int, k: int, partitions: int, device: torch.device) -> dict:
    """Fit at "high" and transform through the port's public API; the
    kernel's launch count is read from 0 around exactly this run."""
    x = bench_workload(rows, n)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    pca = PCA(device=device).setInputCol("features").setK(k).setPrecision("high")
    # warm-up on a slice, so that neither timed fit pays the cuBLAS and
    # cuSOLVER handles' first-use set-up
    pca.fit(x[: 4 * n])
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.perf_counter()
    model = pca.fit(x, num_partitions=partitions)
    sync()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = model.transform(x)
    sync()
    transform_s = time.perf_counter() - t0
    launches = read_launches()

    expected = expected_launches(gram_moments=partitions if cuda else 0)
    if launches != expected:
        raise AssertionError(f"kernel launches in the fit {launches}, expected {expected}")
    min_cos = L.min_cosine_vs_f64_oracle(x, model.pc, k)
    if not min_cos >= COSINE_BAR:
        raise AssertionError(f"min cosine vs the f64 oracle {min_cos} < {COSINE_BAR}")

    t0 = time.perf_counter()
    highest = PCA(device=device).setK(k).setPrecision("highest").fit(
        x, num_partitions=partitions
    )
    sync()
    fit_highest_s = time.perf_counter() - t0
    cos_vs_highest = _min_abs_cosine(model.pc, highest.pc)
    if not cos_vs_highest >= COSINE_BAR:
        raise AssertionError(f"'high' vs 'highest' min cosine {cos_vs_highest} < {COSINE_BAR}")
    # "highest" (f32 products) must give the f64 oracle's explainedVariance.
    # "high" drops the off-diagonal part of loᵀlo (its diagonal is the
    # kernel's Σ(hi + lo)², which drops nothing one-sided). explainedVariance
    # divides by Σ√λ over the full spectrum (448 of 512 values are the noise
    # floor here), so a shift of the floor moves all its ratios together:
    # rtol 1e-3 between tiers. That any gap is this term's is checked: with
    # the off-diagonal loᵀlo added back it is within 1e-4.
    ev_oracle = explained_variance_f64(x, k)
    np.testing.assert_allclose(highest.explainedVariance, ev_oracle, rtol=1e-4)
    np.testing.assert_allclose(model.explainedVariance, highest.explainedVariance, rtol=1e-3)
    ev_rel = np.abs(model.explainedVariance / highest.explainedVariance - 1).max()
    ev_lolo = explained_variance_high_with_lolo(x, k, partitions, device)
    np.testing.assert_allclose(ev_lolo, highest.explainedVariance, rtol=1e-4)
    ev_lolo_rel = np.abs(ev_lolo / highest.explainedVariance - 1).max()

    if out.shape != (rows, k) or not np.isfinite(out).all():
        raise AssertionError(f"transform gave shape {out.shape} or non-finite values")
    ref = x.astype(np.float64) @ model.pc.astype(np.float64)
    proj_err = float(np.abs(out - ref).max())
    proj_tol = 1e-4 * float(np.abs(ref).max())
    if not proj_err <= proj_tol:
        raise AssertionError(f"transform error {proj_err} > {proj_tol}")

    result = {
        "rows": rows, "n": n, "k": k, "partitions": partitions,
        "launches": launches,
        "min_cosine_vs_f64_oracle": min_cos,
        "min_cosine_high_vs_highest": cos_vs_highest,
        "explained_variance_rel_diff_high_vs_highest": float(ev_rel),
        "explained_variance_rel_diff_high_with_lolo_vs_highest": float(ev_lolo_rel),
        "explained_variance_rel_diff_highest_vs_f64": float(
            np.abs(highest.explainedVariance / ev_oracle - 1).max()
        ),
        "transform_max_abs_err": proj_err,
        "transform_tol": proj_tol,
        "fit_s": fit_s,
        "fit_highest_s": fit_highest_s,
        "transform_s": transform_s,
        "max_memory_allocated": torch.cuda.max_memory_allocated(device) if cuda else None,
    }
    print(f"main path: {json.dumps(result)}", flush=True)
    result["model"] = model  # served by phase 10
    return result


def streamed_workload(
    rows: int, n: int, partitions: int, device: torch.device, seed: int = 11
) -> tuple[np.ndarray, np.ndarray]:
    """(x [rows, n] f32 on the host, its f64 Gram), made partition by
    partition on ``device``: one seeded rank-64 mix shared by every
    partition (one spectrum), and a seeded generator per partition for its
    rows and 0.1 noise. The f64 Gram is summed partition by partition, so no
    f64 copy of x is ever made."""
    mix = torch.randn(
        (64, n), generator=torch.Generator(device=device).manual_seed(seed), device=device
    )
    x = np.empty((rows, n), dtype=np.float32)
    gram64 = torch.zeros((n, n), dtype=torch.float64, device=device)
    edges = np.linspace(0, rows, partitions + 1).round().astype(int)
    for p, (lo, hi) in enumerate(zip(edges[:-1], edges[1:])):
        gen = torch.Generator(device=device).manual_seed(seed + 1 + p)
        base = torch.randn((hi - lo, 64), generator=gen, device=device)
        part = base @ mix + 0.1 * torch.randn((hi - lo, n), generator=gen, device=device)
        part64 = part.double()
        gram64 += part64.T @ part64
        torch.from_numpy(x[lo:hi]).copy_(part)
        del base, part, part64
    return x, gram64.cpu().numpy()


def stream_layers(x: np.ndarray, chunk: int, device: torch.device) -> dict:
    """Seconds each layer of the streamed fit takes alone over ``x``'s
    chunks: the staging copy into pinned host memory, the finiteness scan,
    the pinned copy to the card and the kernel; the fit runs them
    overlapped, so its time is not their sum."""
    rows, n = x.shape
    bounds = [(a, min(a + chunk, rows)) for a in range(0, rows, chunk)]
    pinned = torch.empty((chunk, n), dtype=torch.float32, pin_memory=True)
    on_card = torch.empty((chunk, n), dtype=torch.float32, device=device)
    layers = {}
    t0 = time.perf_counter()
    for a, b in bounds:
        pinned[: b - a].copy_(torch.from_numpy(x[a:b]))
    layers["staging_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for a, b in bounds:
        ingest._nonfinite_rows(x[a:b])
    layers["scan_s"] = time.perf_counter() - t0
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for a, b in bounds:
        on_card[: b - a].copy_(pinned[: b - a], non_blocking=True)
    torch.cuda.synchronize(device)
    layers["h2d_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for a, b in bounds:
        G.symmetric_gram_moments(on_card[: b - a])
    torch.cuda.synchronize(device)
    layers["kernel_s"] = time.perf_counter() - t0
    layers["bytes"] = x.nbytes
    return layers


def phase_streamed_path(
    rows: int, n: int, k: int, partitions: int, device: torch.device, data=None
) -> dict:
    """Fit at "high" through the public API on data above the resident
    cutover, so it streams; the kernels' launch counts are read from 0
    around exactly this fit. Then a streamed "highest" fit, both held to the
    f64 oracle. ``data`` is ``streamed_workload``'s (x, f64 Gram), made here
    when not given."""
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    x, gram64 = streamed_workload(rows, n, partitions, device) if data is None else data
    make_s = time.perf_counter() - t0
    if not columnar.use_streamed_fit(columnar.PartitionedDataset.from_any(x, None, partitions)):
        raise AssertionError(f"{rows} x {n} does not cross the streamed-fit cutover")
    chunk = ingest.stream_chunk_rows()
    expected_chunks = -(-rows // chunk)
    # warm-up: two chunks through the fold, so that the timed fit does not
    # pay the pinned staging buffers' first allocation
    ingest.stream_fold([x[: 2 * chunk]], L.gram_fold_step("high"), n=n,
                       init=L.init_gram_carry(n, device), device=device)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.perf_counter()
    model = PCA(device=device).setK(k).setPrecision("high").fit(x, num_partitions=partitions)
    sync()
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    report = model.stream_report
    if report is None:
        raise AssertionError("the fit went resident instead of streaming")

    oracle_pc, oracle_ev = oracle_from_scatter(gram64, k)
    min_cos = _min_abs_cosine(model.pc, oracle_pc)

    t0 = time.perf_counter()
    highest = PCA(device=device).setK(k).setPrecision("highest").fit(
        x, num_partitions=partitions
    )
    sync()
    fit_highest_s = time.perf_counter() - t0
    cos_vs_highest = _min_abs_cosine(model.pc, highest.pc)

    result = {
        "rows": rows, "n": n, "k": k, "partitions": partitions,
        "chunk_rows": chunk, "chunks": report.chunks,
        "overlapped": report.overlapped,
        "copy_overlapped": report.copy_overlapped,
        "overlapped_highest": highest.stream_report.overlapped,
        "max_put_bytes": report.max_put_bytes,
        "launches": launches,
        "min_cosine_vs_f64_oracle": min_cos,
        "min_cosine_high_vs_highest": cos_vs_highest,
        "explained_variance_rel_diff_high_vs_highest": float(
            np.abs(model.explainedVariance / highest.explainedVariance - 1).max()
        ),
        "explained_variance_rel_diff_highest_vs_f64": float(
            np.abs(highest.explainedVariance / oracle_ev - 1).max()
        ),
        "make_data_s": make_s,
        "fit_s": fit_s,
        "fit_highest_s": fit_highest_s,
        "max_memory_allocated": peak,
    }
    if cuda:
        result["layers"] = stream_layers(x, chunk, device)
        busy = result["layers"]["h2d_s"] + result["layers"]["kernel_s"]
        result["device_idle_share_est"] = 1.0 - busy / fit_s
    print(f"main path (streamed): {json.dumps(result)}", flush=True)

    expected = expected_launches(symmetric_gram_moments=expected_chunks if cuda else 0)
    if launches != expected:
        raise AssertionError(f"kernel launches in the streamed fit {launches}, expected {expected}")
    if report.chunks != expected_chunks or report.rows != rows:
        raise AssertionError(f"the fit did not stream {expected_chunks} chunks: {report}")
    if not min_cos >= COSINE_BAR:
        raise AssertionError(f"streamed min cosine vs the f64 oracle {min_cos} < {COSINE_BAR}")
    if not cos_vs_highest >= COSINE_BAR:
        raise AssertionError(f"streamed 'high' vs 'highest' min cosine {cos_vs_highest}")
    # the tolerances of the resident phase, for the same reasons
    np.testing.assert_allclose(highest.explainedVariance, oracle_ev, rtol=1e-4)
    np.testing.assert_allclose(model.explainedVariance, highest.explainedVariance, rtol=1e-3)
    if cuda and not peak < STREAM_PEAK_BYTES:
        raise AssertionError(f"streamed fit peaked at {peak} B of device memory")
    # The fit is host-bound (staging reads and writes each chunk in host
    # memory, the card only reads it once), so a chunk is rarely ready
    # before the previous fold ends and ``overlapped`` is near 0 by design;
    # what must hold is that every copy runs beside the host's staging.
    if cuda and not report.copy_overlapped > 0:
        raise AssertionError(f"no copy to the card overlapped the host's staging: {report}")
    return result


def scatter_f64(x: np.ndarray, device: torch.device, chunk: int = 65_536) -> np.ndarray:
    """XᵀX of a host f32 matrix, summed in f64 on ``device`` a chunk of rows
    at a time (no f64 copy of x on the host)."""
    n = x.shape[1]
    total = torch.zeros((n, n), dtype=torch.float64, device=device)
    for a in range(0, x.shape[0], chunk):
        part = torch.from_numpy(x[a:a + chunk]).to(device=device, dtype=torch.float64)
        total += part.T @ part
    return total.cpu().numpy()


def randomized_f64(
    scatter: np.ndarray, k: int, omega: np.ndarray, power_iters: int = 2
) -> tuple[np.ndarray, np.ndarray]:
    """The randomized solver's steps (HMT subspace iteration, Rayleigh–Ritz,
    the trace-based tail estimate of explainedVariance) in f64 with numpy on
    the host, on a given sketch: (components [n, k], explainedVariance [k]),
    held to the same orientation rule as the port's."""
    a = np.asarray(scatter, np.float64)
    n, l = omega.shape
    q, _ = np.linalg.qr(a @ omega)
    for _ in range(power_iters):
        q, _ = np.linalg.qr(a @ q)
    b = q.T @ a @ q
    evals, v = np.linalg.eigh(0.5 * (b + b.T))
    evals, v = evals[::-1], v[:, ::-1][:, :k]
    u = q @ v
    u = u * np.where(u[np.argmax(np.abs(u), axis=0), np.arange(k)] < 0, -1.0, 1.0)
    s = np.sqrt(np.clip(evals, 0.0, None))
    tail = np.sqrt(max(np.trace(a) - (s**2).sum(), 0.0) * (n - l))
    return u, (s / (s.sum() + tail))[:k]


def _host_ms(fn, device: torch.device, reps: int = 5) -> list[float]:
    """Wall times (ms) of ``fn`` after a warm-up, each ended by a
    synchronise: the decomposition stage as a fit sees it, host syncs
    inside the solvers included."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def phase_solvers(rows: int, n: int, k: int, partitions: int, device: torch.device) -> dict:
    """Fit the resident shape at "high" with solvers "svd", "randomized" and
    "auto" through the public API; "auto" must take the randomized route
    (bit-equal fits: n ≥ 256 and k + 10 ≤ n/4). Then the decomposition stage
    alone, timed after the statistics, for "full", "randomized" and "svd".

    Gates: "svd" against the f64 eigen-oracle (min |cos| ≥ 0.9999); the
    randomized fit against the same HMT steps in f64 on the host on the same
    sketch Ω (min |cos| ≥ 0.9999, explainedVariance rtol 1e-4). At k = 50 on
    this rank-64 data the sketch of l = 60 columns cannot converge the
    trailing Ritz vectors, so the randomized fit's cosine against the exact
    oracle is printed, not gated."""
    x = bench_workload(rows, n)
    cuda = device.type == "cuda"
    scatter = scatter_f64(x, device)
    oracle_pc, _ = oracle_from_scatter(scatter, k)
    fits, fit_s, launches = {}, {}, {}
    for solver in ("svd", "randomized", "auto"):
        pca = PCA(device=device).setK(k).setPrecision("high").setSolver(solver)
        reset_launches()
        t0 = time.perf_counter()
        fits[solver] = pca.fit(x, num_partitions=partitions)
        if cuda:
            torch.cuda.synchronize(device)
        fit_s[solver] = time.perf_counter() - t0
        launches[solver] = read_launches()

    # the decomposition stage alone, on the fit's own statistics
    pca = PCA(device=device).setK(k).setPrecision("high")
    mats = list(columnar.PartitionedDataset.from_any(x, None, partitions).matrices())
    cov = L.covariance_from_stats(pca._resident_gram_stats(mats, "high"), mean_centering=False)
    r = pca._reduce_r(mats, False)
    decomposition_ms = {
        "full": _host_ms(lambda: L.pca_fit_from_cov(cov, k, solver="full"), device),
        "randomized": _host_ms(lambda: L.pca_fit_from_cov(cov, k, solver="randomized"), device),
        "svd": _host_ms(lambda: L.svd_from_r(r, k), device),
    }

    # the fit's sketch is the seeded one the smoke draws here
    l = k + 10
    omega = torch.randn((n, l), generator=torch.Generator(device=device).manual_seed(0),
                        device=device)
    seeded = L.randomized_eigh_descending(cov, k)
    given = L.randomized_eigh_descending(cov, k, omega=omega)
    same_sketch = all(torch.equal(a, b) for a, b in zip(seeded, given))
    hmt_pc, hmt_ev = randomized_f64(scatter, k, omega.cpu().double().numpy())
    rand = fits["randomized"]
    result = {
        "rows": rows, "n": n, "k": k, "partitions": partitions,
        "launches": launches,
        "fit_s": fit_s,
        "decomposition_ms": decomposition_ms,
        "auto_bit_equal_randomized": bool(
            np.array_equal(fits["auto"].pc, rand.pc)
            and np.array_equal(fits["auto"].explainedVariance, rand.explainedVariance)
        ),
        "same_sketch": same_sketch,
        "svd_min_cosine_vs_f64_oracle": _min_abs_cosine(fits["svd"].pc, oracle_pc),
        "randomized_min_cosine_vs_f64_hmt": _min_abs_cosine(rand.pc, hmt_pc),
        "randomized_explained_variance_rel_diff_vs_f64_hmt": float(
            np.abs(rand.explainedVariance / hmt_ev - 1).max()
        ),
        "randomized_min_cosine_vs_f64_oracle": _min_abs_cosine(rand.pc, oracle_pc),
        "randomized_cosine_vs_f64_oracle_first_10": float(
            _min_abs_cosine(rand.pc[:, :10], oracle_pc[:, :10])
        ),
    }
    print(f"solvers: {json.dumps(result)}", flush=True)
    if not result["auto_bit_equal_randomized"]:
        raise AssertionError("solver 'auto' did not take the randomized route")
    if not same_sketch:
        raise AssertionError("the seeded sketch differs from the one the smoke drew")
    if not result["svd_min_cosine_vs_f64_oracle"] >= COSINE_BAR:
        raise AssertionError(f"svd fit vs the f64 oracle: {result}")
    if not result["randomized_min_cosine_vs_f64_hmt"] >= COSINE_BAR:
        raise AssertionError(f"randomized fit vs the f64 HMT steps: {result}")
    np.testing.assert_allclose(rand.explainedVariance, hmt_ev, rtol=1e-4)
    expected = expected_launches(gram_moments=partitions if cuda else 0)
    for solver, expect in (("svd", expected_launches()), ("randomized", expected),
                           ("auto", expected)):
        if launches[solver] != expect:
            raise AssertionError(f"{solver} fit launched {launches[solver]}, expected {expect}")
    return result


def phase_one_pass(rows: int, n: int, k: int, partitions: int, device: torch.device) -> dict:
    """Fit the resident shape at precision "default" (one bf16 pass) through
    the public API; its launches are read from 0 around exactly this fit and
    must all be the fused one-product instance's. Gate: min |cos| against
    the f64 oracle ≥ 0.9999 (by estimate the bf16 Gram's error is about 4e-4
    of the eigengap at 500,000 rows). The explainedVariance gaps to a
    "highest" fit and to the f64 oracle are printed, and the latter also for
    the kernels' own Gram with its diagonal Σhi², which the unstandardized
    fit keeps (``ops/linalg.py``'s rule), so the two agree."""
    x = bench_workload(rows, n)
    cuda = device.type == "cuda"
    reset_launches()
    t0 = time.perf_counter()
    model = PCA(device=device).setK(k).setPrecision("default").fit(x, num_partitions=partitions)
    if cuda:
        torch.cuda.synchronize(device)
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    highest = PCA(device=device).setK(k).setPrecision("highest").fit(x, num_partitions=partitions)
    oracle_pc, oracle_ev = oracle_from_scatter(scatter_f64(x, device), k)
    # the kernels' own Gram with its diagonal Σhi², summed here outside the
    # fit: the unstandardized fit keeps that diagonal
    unrepaired = sum(
        G.fused_gram_moments(torch.from_numpy(columnar.pad_rows(part)[0]).to(device),
                             products=1)[0]
        for part in np.array_split(x, partitions)
    )
    ev_unrepaired = L.pca_fit_from_cov(unrepaired, k)[1].cpu().numpy()
    result = {
        "rows": rows, "n": n, "k": k, "partitions": partitions,
        "launches": launches,
        "fit_s": fit_s,
        "min_cosine_vs_f64_oracle": _min_abs_cosine(model.pc, oracle_pc),
        "explained_variance_rel_diff_default_vs_highest": float(
            np.abs(model.explainedVariance / highest.explainedVariance - 1).max()
        ),
        "explained_variance_rel_diff_default_vs_f64": float(
            np.abs(model.explainedVariance / oracle_ev - 1).max()
        ),
        "explained_variance_rel_diff_sum_hi_sq_diagonal_vs_f64": float(
            np.abs(ev_unrepaired / oracle_ev - 1).max()
        ),
    }
    print(f"one pass (resident): {json.dumps(result)}", flush=True)
    expected = expected_launches(gram_moments_1pass=partitions if cuda else 0)
    if launches != expected:
        raise AssertionError(
            f"kernel launches in the 'default' fit {launches}, expected {expected}"
        )
    if not result["min_cosine_vs_f64_oracle"] >= COSINE_BAR:
        raise AssertionError(f"'default' fit vs the f64 oracle: {result}")
    return result


POLICY_ROWS = 1_000_000  # the policy's streamed fit: above the cutover at 512 columns


def phase_streamed_one_pass(
    data, k: int, partitions: int, device: torch.device, policy_rows: int = POLICY_ROWS
) -> dict:
    """On ``streamed_workload``'s (x, f64 Gram): a streamed fit at precision
    "default", whose launches (read from 0 around exactly it) must all be
    the symmetric one-product instance's, one per chunk; then a streamed fit
    at "highest" under TPU_ML_PRECISION_POLICY=bf16_f32acc on the first
    ``policy_rows`` rows, which runs the same instance. Both are held to the
    f64 oracle of their rows (min |cos| ≥ 0.9999); the explainedVariance gap
    to a streamed "highest" fit is printed. The environment is restored."""
    import os

    x, gram64 = data
    rows, n = x.shape
    cuda = device.type == "cuda"
    chunk = ingest.stream_chunk_rows()
    reset_launches()
    t0 = time.perf_counter()
    model = PCA(device=device).setK(k).setPrecision("default").fit(x, num_partitions=partitions)
    if cuda:
        torch.cuda.synchronize(device)
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    highest = PCA(device=device).setK(k).setPrecision("highest").fit(x, num_partitions=partitions)
    oracle_pc, oracle_ev = oracle_from_scatter(gram64, k)

    x_policy = x[:policy_rows]
    before = os.environ.get("TPU_ML_PRECISION_POLICY")
    os.environ["TPU_ML_PRECISION_POLICY"] = "bf16_f32acc"
    try:
        reset_launches()
        t0 = time.perf_counter()
        policy_model = PCA(device=device).setK(k).setPrecision("highest").fit(
            x_policy, num_partitions=2
        )
        if cuda:
            torch.cuda.synchronize(device)
        policy_fit_s = time.perf_counter() - t0
        policy_launches = read_launches()
    finally:
        if before is None:
            del os.environ["TPU_ML_PRECISION_POLICY"]
        else:
            os.environ["TPU_ML_PRECISION_POLICY"] = before
    policy_pc, _ = oracle_from_scatter(scatter_f64(x_policy, device), k)
    result = {
        "rows": rows, "n": n, "k": k, "partitions": partitions,
        "launches": launches,
        "chunks": model.stream_report.chunks if model.stream_report else None,
        "fit_s": fit_s,
        "min_cosine_vs_f64_oracle": _min_abs_cosine(model.pc, oracle_pc),
        "explained_variance_rel_diff_default_vs_highest": float(
            np.abs(model.explainedVariance / highest.explainedVariance - 1).max()
        ),
        "explained_variance_rel_diff_default_vs_f64": float(
            np.abs(model.explainedVariance / oracle_ev - 1).max()
        ),
        "policy_rows": policy_rows,
        "policy_launches": policy_launches,
        "policy_chunks": (policy_model.stream_report.chunks
                          if policy_model.stream_report else None),
        "policy_fit_s": policy_fit_s,
        "policy_min_cosine_vs_f64_oracle": _min_abs_cosine(policy_model.pc, policy_pc),
    }
    print(f"one pass (streamed): {json.dumps(result)}", flush=True)
    expected = expected_launches(symmetric_gram_moments_1pass=-(-rows // chunk) if cuda else 0)
    if launches != expected or model.stream_report is None:
        raise AssertionError(f"streamed 'default' fit launched {launches}, expected {expected}")
    policy_expected = expected_launches(
        symmetric_gram_moments_1pass=-(-policy_rows // chunk) if cuda else 0
    )
    if policy_launches != policy_expected or policy_model.stream_report is None:
        raise AssertionError(
            f"streamed fit under the policy launched {policy_launches}, expected {policy_expected}"
        )
    for key in ("min_cosine_vs_f64_oracle", "policy_min_cosine_vs_f64_oracle"):
        if not result[key] >= COSINE_BAR:
            raise AssertionError(f"{key} {result[key]} < {COSINE_BAR}: {result}")
    return result


def phase_standardize(rows: int, n: int, k: int, partitions: int, device: torch.device) -> dict:
    """Fit with standardize=True at "high" (resident) and hold its
    components to the f64 eigenvectors of the standardized data's scatter,
    (x − μ)/σ with the sample σ, formed directly from the rows."""
    x = bench_workload(rows, n)
    model = PCA(device=device).setK(k).setPrecision("high").setStandardize(True).fit(
        x, num_partitions=partitions
    )
    x64 = torch.from_numpy(x).to(device=device, dtype=torch.float64)
    mean, std = x64.mean(dim=0), x64.std(dim=0)
    xs = (x64 - mean) / torch.where(std > 0, std, torch.ones_like(std))
    oracle_pc, _ = oracle_from_scatter((xs.T @ xs).cpu().numpy(), k)
    min_cos = _min_abs_cosine(model.pc, oracle_pc)
    result = {
        "rows": rows, "n": n, "k": k,
        "min_cosine_vs_f64_oracle": min_cos,
        "mean_max_abs_err": float(np.abs(model.mean - mean.cpu().numpy()).max()),
        "std_max_rel_err": float(np.abs(model.std / std.cpu().numpy() - 1).max()),
    }
    print(f"standardize: {json.dumps(result)}", flush=True)
    if not min_cos >= COSINE_BAR:
        raise AssertionError(f"standardize min cosine vs the f64 oracle {min_cos} < {COSINE_BAR}")
    result["model"] = model  # served by phase 10
    result["oracle_pc"] = oracle_pc  # phase 11's oracle
    return result


# -- phase 11: BASELINE config 4 ---------------------------------------------

# The streamed scaler's moments against f64 host moments. The fold adds
# 153 chunk sums into an f32 carry: each chunk's sum of 65,536 values by
# the card's tree reduction, each carry add one f32 rounding (2⁻²⁴). Σx² of
# a column (about 6.4e8 here) is then off by at most 153·2⁻²⁴ relative from
# the adds (9e-6) and far less from the tree sums; a centred column's std
# carries half of it: rtol 1e-5. The mean is off by at most
# Σ|partial sums| · 153·2⁻²⁴ / rows, under 1e-7 σ here: gated at 1e-5 σ.
STREAM_SCALER_STD_RTOL = 1e-5
STREAM_SCALER_MEAN_TOL_SIGMAS = 1e-5


def column_sums_f64(x: np.ndarray, device: torch.device, chunk: int = 65_536) -> np.ndarray:
    """Σx per column of a host f32 matrix, in f64 on ``device`` a chunk of
    rows at a time."""
    total = torch.zeros(x.shape[1], dtype=torch.float64, device=device)
    for a in range(0, x.shape[0], chunk):
        total += torch.from_numpy(x[a:a + chunk]).to(device).double().sum(dim=0)
    return total.cpu().numpy()


def _fit_report_gates(report, caller_s: float, rows: int, device: torch.device) -> None:
    """A FitReport's rows, peak device memory and wall time, held to what
    the caller knows."""
    if report.rows_ingested != rows:
        raise AssertionError(f"{report.estimator} report ingested {report.rows_ingested} rows, "
                             f"not {rows}")
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
        if not 0 < report.peak_device_bytes < total:
            raise AssertionError(f"{report.estimator} report peak {report.peak_device_bytes} B "
                                 f"outside (0, {total})")
    if not report.wall_seconds <= caller_s:
        raise AssertionError(f"{report.estimator} report wall {report.wall_seconds} s > the "
                             f"caller's {caller_s} s")


def phase_pipeline(rows: int, n: int, k: int, partitions: int, device: torch.device,
                   standardized: dict) -> dict:
    """BASELINE config 4 through the public API: Pipeline([StandardScaler,
    PCA]) and Pipeline([Normalizer, PCA]) at "high", each fit with the
    kernels' launch counts read from 0 around exactly it, then every row
    transformed. ``standardized`` is phase 7's result (its model and its
    f64 oracle)."""
    x = bench_workload(rows, n)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    ds = columnar.PartitionedDataset.from_any(x, None, partitions)
    x64 = torch.from_numpy(x).to(device=device, dtype=torch.float64)
    norms = torch.linalg.vector_norm(x64, dim=1, keepdim=True)
    xn = x64 / torch.where(norms > 0, norms, torch.ones_like(norms))
    normalized_oracle, _ = oracle_from_scatter((xn.T @ xn).cpu().numpy(), k)
    del xn
    cases = {
        "scaler": (StandardScaler(device=device, withMean=True, withStd=True),
                   standardized["oracle_pc"]),
        "normalizer": (Normalizer(device=device, p=2.0), normalized_oracle),
    }
    results = {}
    for name, (pre, oracle_pc) in cases.items():
        pca = PCA(device=device).setK(k).setPrecision("high")
        sync()
        reset_launches()
        t0 = time.perf_counter()
        model = Pipeline(stages=[pre, pca]).fit(ds)
        sync()
        fit_s = time.perf_counter() - t0
        launches = read_launches()
        t0 = time.perf_counter()
        out = model.transform(x)
        sync()
        transform_s = time.perf_counter() - t0

        stage0, fitted_pca = model.stages
        pc = fitted_pca.pc
        if name == "scaler":
            mean = torch.from_numpy(stage0.mean).to(device, torch.float64)
            std = torch.from_numpy(stage0.std).to(device, torch.float64)
            pre64 = (x64 - mean) / torch.where(std > 0, std, torch.ones_like(std))
        else:
            pre64 = x64 / torch.where(norms > 0, norms, torch.ones_like(norms))
        ref = (pre64 @ torch.from_numpy(pc).to(device, torch.float64)).cpu().numpy()
        del pre64
        report = model.fit_report
        result = {
            "rows": rows, "n": n, "k": k, "partitions": partitions, "launches": launches,
            "min_cosine_vs_f64_oracle": _min_abs_cosine(pc, oracle_pc),
            "transform_max_abs_err": float(np.abs(out - ref).max()),
            "transform_tol": 1e-4 * float(np.abs(ref).max()),
            "fit_s": fit_s, "transform_s": transform_s,
            "stage_fit_s": {type(s).__name__: s.fit_report.wall_seconds
                            for s in model.stages if getattr(s, "fit_report", None)},
            "stage_transform_s": {type(s).__name__: s.transform_report.wall_seconds
                                  for s in model.stages},
        }
        if name == "scaler":
            result["min_cosine_vs_standardize_fit"] = _min_abs_cosine(
                pc, standardized["model"].pc)
        print(f"config 4 ({name}): {json.dumps(result)}", flush=True)
        print(f"config 4 ({name}) fit report: {json.dumps(report.to_dict())}", flush=True)

        expected = expected_launches(gram_moments=partitions if cuda else 0)
        if launches != expected:
            raise AssertionError(f"config 4 ({name}) launches {launches}, expected {expected}")
        for key in ("min_cosine_vs_f64_oracle", "min_cosine_vs_standardize_fit"):
            if key in result and not result[key] >= COSINE_BAR:
                raise AssertionError(f"config 4 ({name}) {key} {result[key]} < {COSINE_BAR}")
        if out.shape != (rows, k) or not np.isfinite(out).all():
            raise AssertionError(f"config 4 ({name}) transform gave {out.shape} or non-finite")
        if not result["transform_max_abs_err"] <= result["transform_tol"]:
            raise AssertionError(f"config 4 ({name}) transform error {result}")
        _fit_report_gates(report, fit_s, rows, device)
        result["model"] = model
        result["fit_id"] = report.fit_id
        results[name] = result
    return results


def phase_streamed_scaler(data, partitions: int, device: torch.device) -> dict:
    """StandardScaler on phase 8's streamed data: above the cutover it folds
    the moments chunk by chunk (``stream_fold`` + ``moment_fold_step``), no
    Gram kernel; count, mean and std held to f64 host moments."""
    x, gram64 = data
    rows, n = x.shape
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    reset_launches()
    t0 = time.perf_counter()
    model = StandardScaler(device=device).fit(x, num_partitions=partitions)
    if cuda:
        torch.cuda.synchronize(device)
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    rep, report = model.stream_report, model.fit_report
    if rep is None:
        raise AssertionError("the scaler fit went resident instead of streaming")
    mean64 = column_sums_f64(x, device) / rows
    std64 = np.sqrt((np.diag(gram64) - rows * mean64 ** 2) / (rows - 1))
    result = {
        "rows": rows, "n": n, "chunks": rep.chunks, "fit_s": fit_s, "launches": launches,
        "mean_max_err_in_sigmas": float(np.max(np.abs(model.mean - mean64) / std64)),
        "std_max_rel_err": float(np.max(np.abs(model.std / std64 - 1))),
        "overlap_fraction": report.overlap_fraction, "h2d_bytes": report.h2d_bytes,
        "rows_ingested": report.rows_ingested,
        "copy_overlapped": rep.copy_overlapped,
    }
    print(f"streamed scaler: {json.dumps(result)}", flush=True)
    print(f"streamed scaler fit report: {json.dumps(report.to_dict())}", flush=True)
    if launches != expected_launches():
        raise AssertionError(f"the moments fold launched a Gram kernel: {launches}")
    if rep.rows != rows or rep.chunks != -(-rows // ingest.stream_chunk_rows()):
        raise AssertionError(f"the scaler fold did not take every row once: {rep}")
    if report.h2d_bytes != (x.nbytes if cuda else 0):
        raise AssertionError(f"h2d_bytes {report.h2d_bytes}, expected {x.nbytes}")
    if not result["mean_max_err_in_sigmas"] <= STREAM_SCALER_MEAN_TOL_SIGMAS:
        raise AssertionError(f"streamed scaler mean off: {result}")
    if not result["std_max_rel_err"] <= STREAM_SCALER_STD_RTOL:
        raise AssertionError(f"streamed scaler std off: {result}")
    _fit_report_gates(report, fit_s, rows, device)
    return result


# -- phase 10: serving -------------------------------------------------------

SERVE_REL_TOL = 1e-5  # max abs error ≤ SERVE_REL_TOL × max |expected|
SERVE_POOL_ROWS = 65_536
SERVE_TIMED_REPS = 200


@contextlib.contextmanager
def _env(**values: str | None):
    """Set (or, for None, unset) environment variables for the block."""
    before = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def eager_at_bucket(model, rows: np.ndarray, bucket: int) -> np.ndarray:
    """The model's eager transform of ``rows`` with its padding bucket set
    to ``bucket`` (rows ≤ bucket), the shape a serve rung computes."""
    with _env(TPU_ML_MIN_BUCKET=str(bucket)):
        return model.transform(rows)


def f64_projection(entry, rows: np.ndarray) -> np.ndarray:
    """The f64 reference of a served answer: the model's standardization
    and projection in f64; for the bf16 variant, the f64 product of the
    bf16-rounded operands; for a scaler, its standardize in f64; for a GLM,
    its margin x·coef + b in f64 (b as the f32 the servable holds)."""
    m = entry.model
    x = rows.astype(np.float64)
    if entry.family == "linear":
        coef = np.asarray(m.coefficients, dtype=np.float64)
        if entry.policy == "bf16_f32acc":
            def bf16(a):
                return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().double().numpy()

            return bf16(x.astype(np.float32)) @ bf16(coef) + np.float32(m.intercept)
        return x @ coef + np.float32(m.intercept)
    if entry.family == "scaler":
        if m.getWithMean():
            x = x - m.mean
        return x / np.where(m.std > 0, m.std, 1.0) if m.getWithStd() else x
    if m.mean is not None:
        x = (x - m.mean) / np.where(m.std > 0, m.std, 1.0)
    pc = np.asarray(m.pc, dtype=np.float64)
    if entry.policy == "bf16_f32acc":
        def bf16(a):
            return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().double().numpy()

        return bf16(x.astype(np.float32)) @ bf16(pc)
    return x @ pc


def _rel_err(got: np.ndarray, expected: np.ndarray) -> float:
    return float(np.abs(got - expected).max() / max(np.abs(expected).max(), 1e-30))


def _pcts(samples_s: list[float]) -> dict:
    a = np.asarray(samples_s) * 1e3
    return {"n": len(a), "p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99)), "mean_ms": float(a.mean())}


def serve_rung_checks(reg, device: torch.device, pool: np.ndarray, reps: int) -> dict:
    """Per model and rung: the graph's answer on a full block of pool rows
    against the eager kernel on the same padded block (bit for bit), the
    model's transform at that bucket (bit for bit, f32 models) and the f64
    projection (relative bound); then the replay and the eager kernel timed
    with CUDA events (device ms per launch) and the whole dispatch against
    the eager path (host ms: staging, copies, product, copy back)."""
    cuda = device.type == "cuda"
    out = {}
    for name in reg.names():
        entry = reg.get(name)
        rungs, first_rows = [], {}
        for b in sorted(entry.warm_buckets):
            rows = pool[:b]
            padded = entry.prepare(rows).astype(np.float32)
            served = reg.dispatch_padded(entry, padded, b)
            xd = torch.from_numpy(padded).to(device)
            eager = entry.kernel(entry.params, xd).cpu().numpy()
            row = {"bucket": b, "bitwise_vs_eager_kernel": bool(np.array_equal(served, eager)),
                   "rel_err_vs_f64": _rel_err(served, f64_projection(entry, rows))}
            if entry.policy == "f32":
                row["bitwise_vs_transform"] = bool(
                    np.array_equal(served, eager_at_bucket(entry.model, rows, b))
                )
            first_rows[b] = served[0]
            if cuda:
                rung = entry.rungs[b]
                with rung.lock:
                    for label, fn in (("replay", rung.graph.replay),
                                      ("eager", lambda: entry.kernel(entry.params, rung.x))):
                        fn()
                        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                        start.record()
                        for _ in range(reps):
                            fn()
                        stop.record()
                        stop.synchronize()
                        row[f"{label}_device_ms"] = start.elapsed_time(stop) / reps

            def eager_path():
                return entry.kernel(entry.params, torch.from_numpy(padded).to(device)).cpu().numpy()

            for label, fn in (("dispatch", lambda: reg.dispatch_padded(entry, padded, b)),
                              ("eager_path", eager_path)):
                fn()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                row[f"{label}_host_ms"] = (time.perf_counter() - t0) / reps * 1e3
            rungs.append(row)
        base = first_rows[min(first_rows)]
        out[name] = {
            "policy": entry.policy,
            "rungs": rungs,
            # whether one row's answer was the same bits at every bucket
            "row_bitwise_equal_across_buckets": all(
                np.array_equal(r, base) for r in first_rows.values()
            ),
        }
        for r in rungs:
            if not r["bitwise_vs_eager_kernel"] or not r.get("bitwise_vs_transform", True):
                raise AssertionError(f"{name}: rung {r['bucket']} differs from eager: {r}")
            if not r["rel_err_vs_f64"] <= SERVE_REL_TOL:
                raise AssertionError(f"{name}: rung {r['bucket']} f64 error {r}")
    return out


def _uds_path(directory: str) -> str:
    """A socket path in ``directory``, or, where that path is too long for
    AF_UNIX, a name relative to the working directory."""
    path = os.path.join(directory, "s.sock")
    return path if len(path) < 100 else f".serve-{os.getpid()}.sock"


def _read_exact(rfile, n: int) -> bytes:
    data = rfile.read(n)
    if len(data) != n:
        raise EOFError("server closed mid-frame")
    return data


class _Wires:
    """One caller's connections to the four wires of a running server."""

    def __init__(self, srv):
        self.http = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        self.client = serve_client.ServeClient(srv.batcher)
        self.uds = socket.socket(socket.AF_UNIX)
        self.uds.connect(srv.uds_path)
        self.uds_r = self.uds.makefile("rb")

    def close(self):
        self.http.close()
        self.uds_r.close()
        self.uds.close()

    def inproc(self, model: str, rows: np.ndarray) -> np.ndarray:
        return self.client.predict(model, rows)

    def http_binary(self, model: str, rows: np.ndarray) -> np.ndarray:
        """One request on the caller's persistent HTTP/1.1 connection."""
        self.http.request("POST", f"/v1/models/{model}:predict", body=rows.tobytes(), headers={
            "Content-Type": S.BINARY_CONTENT_TYPE, "Accept": S.BINARY_CONTENT_TYPE,
            S.SHAPE_HEADER: f"{rows.shape[0]},{rows.shape[1]}",
        })
        resp = self.http.getresponse()
        body = resp.read()
        if resp.status != 200:
            raise AssertionError(f"HTTP {resp.status}: {body[:200]!r}")
        shape = [int(d) for d in resp.getheader(S.SHAPE_HEADER).split(",")]
        return np.frombuffer(body, dtype="<f4").reshape(shape)

    def uds_json(self, model: str, rows: np.ndarray) -> np.ndarray:
        raw = json.dumps({"model": model, "wire": "json", "instances": rows.tolist()}).encode()
        self.uds.sendall(len(raw).to_bytes(4, "big") + raw)
        n = int.from_bytes(_read_exact(self.uds_r, 4), "big")
        resp = json.loads(_read_exact(self.uds_r, n))
        if not resp["ok"]:
            raise AssertionError(f"UDS error: {resp}")
        return np.asarray(resp["predictions"], dtype=np.float32)

    def fast(self, model: str, rows: np.ndarray) -> np.ndarray:
        self.uds.sendall(FL.pack_request(model, rows))
        return FL.read_response(lambda n: _read_exact(self.uds_r, n))


WIRES = ("inproc", "http_binary", "uds_json", "fast")


def span_breakdown(events: list[dict]) -> dict:
    """Where each traced request's server-side time went, from the flight
    recorder's spans (µs, p50/p99): ``prepare`` (request span start to
    queueing: body read, validation, prepare, the f32 cast), ``queue`` (the
    coalescing wait), ``assemble`` (late join, concatenation, padding),
    ``dispatch`` (staging, H2D, replay, D2H, sync) and ``after`` (finalize,
    the waiting thread's wake-up, booking)."""
    requests, dispatches = {}, {}
    for e in events:
        args = e.get("args", {})
        if e["name"] == "serve.request" and "span_id" in args:
            requests[args["span_id"]] = e
        elif e["name"] == "serve.dispatch":
            for token in args.get("links", "").split():
                dispatches[token.partition(":")[2]] = e
    parts: dict[str, list] = {k: [] for k in ("prepare", "queue", "assemble", "dispatch", "after")}
    for q in events:
        if q["name"] != "serve.queue":
            continue
        r = requests.get(q["args"].get("parent_id"))
        d = dispatches.get(q["args"].get("parent_id"))
        if r is None or d is None:
            continue
        parts["prepare"].append(q["ts"] - r["ts"])
        parts["queue"].append(q["dur"])
        parts["assemble"].append(d["ts"] - q["ts"] - q["dur"])
        parts["dispatch"].append(d["dur"])
        parts["after"].append(r["ts"] + r["dur"] - d["ts"] - d["dur"])
    return {
        k: {"n": len(v), "p50_us": float(np.percentile(v, 50)), "p99_us": float(np.percentile(v, 99))}
        for k, v in parts.items() if v
    }


def serve_latency_traffic(srv, reg, model: str, pool: np.ndarray, requests: int,
                          seed: int) -> dict:
    """``requests`` sequential one-row requests on each wire. Every answer
    is held bit for bit against the eager transform at bucket 8 (each
    request dispatches alone) and to the f64 projection; no capture may
    happen, and the fast lane may not touch the JSON codec."""
    entry = reg.get(model)
    idx = np.random.default_rng(seed).integers(0, len(pool), size=requests)
    rows = pool[idx]
    b0 = B.serve_bucket(1)
    eager = np.concatenate([eager_at_bucket(entry.model, rows[i:i + 1], b0)
                            for i in range(requests)])
    ref64 = f64_projection(entry, rows)
    tol = SERVE_REL_TOL * float(np.abs(ref64).max())
    wires = _Wires(srv)
    out = {}
    try:
        before = REGISTRY.snapshot()
        for wire in WIRES:
            call = getattr(wires, wire)
            call(model, rows[:1])  # the connection's first request is not timed
            snap, seq = REGISTRY.snapshot(), TIMELINE.seq()
            lat, mismatched, max_err = [], 0, 0.0
            for i in range(requests):
                t0 = time.perf_counter()
                got = call(model, rows[i:i + 1])
                lat.append(time.perf_counter() - t0)
                mismatched += not np.array_equal(got, eager[i:i + 1])
                max_err = max(max_err, float(np.abs(got - ref64[i:i + 1]).max()))
            delta = REGISTRY.snapshot().delta(snap)
            out[wire] = {**_pcts(lat), "bitwise_mismatches": mismatched,
                         "max_abs_err_vs_f64": max_err, "tol": tol,
                         "json_codec": delta.counter("serve.json_codec"),
                         "batches": delta.counter("serve.batches"),
                         "queue_delay_us": delta.hist("serve.queue_delay_us").to_dict(),
                         "server_latency": delta.hist("serve.latency").to_dict(),
                         "window_s": delta.hist("serve.window_effective_seconds").to_dict(),
                         "spans": span_breakdown(TIMELINE.events(since_seq=seq))}
            if mismatched or not max_err <= tol:
                raise AssertionError(f"{wire}: {out[wire]}")
        delta = REGISTRY.snapshot().delta(before)
    finally:
        wires.close()
    if out["fast"]["json_codec"] != 0:
        raise AssertionError(f"the fast lane touched the JSON codec: {out['fast']}")
    captures = delta.counter("compile.graph_captures") + delta.counter("serve.cold_compiles")
    if captures:
        raise AssertionError(f"{captures} captures during the latency traffic")
    return out


def serve_batcher_alone(reg, model: str, pool: np.ndarray, requests: int) -> dict:
    """What the batcher adds to a lone one-row request: ``requests``
    sequential requests through ``predict`` directly, through a batcher with
    the configured window, and through one with a zero window (p50/p99)."""
    out = {}
    for label in ("direct", "batcher", "batcher_zero_window"):
        batcher = None
        if label != "direct":
            batcher = MicroBatcher(reg, max_delay_s=0.0 if label.endswith("window") else None)
            batcher.start()
        try:
            lat = []
            for i in range(requests + 1):
                rows = pool[i:i + 1]
                t0 = time.perf_counter()
                if batcher is None:
                    reg.predict(model, rows)
                else:
                    batcher.submit(model, rows).result(30.0)
                if i:  # the first request is not timed
                    lat.append(time.perf_counter() - t0)
        finally:
            if batcher is not None:
                batcher.stop()
        out[label] = _pcts(lat)
    return out


def serve_mixed_traffic(srv, reg, model: str, pool: np.ndarray, requests: int, threads: int,
                        seed: int) -> dict:
    """``requests`` requests of 1 to the ladder cap rows, log-uniform, from
    ``threads`` threads, alternating HTTP binary and the fast lane. Every
    answer is held to the f64 projection; a sample of them is compared bit
    for bit with the eager transform at the request's own bucket (not a
    gate: coalescing may put a request in a larger bucket). There must be
    fewer dispatches than requests and no capture."""
    entry = reg.get(model)
    ref64_pool = f64_projection(entry, pool)
    tol = SERVE_REL_TOL * float(np.abs(ref64_pool).max())
    cap = B.max_batch_rows()
    per_thread = requests // threads
    results: list[list] = [[] for _ in range(threads)]
    errors: list[BaseException] = []

    def worker(t: int) -> None:
        rng = np.random.default_rng(seed + t)
        wires = None
        try:
            wires = _Wires(srv)
            for i in range(per_thread):
                r = min(cap, int(np.exp(rng.uniform(0.0, np.log(cap + 1)))))
                off = int(rng.integers(0, len(pool) - r + 1))
                wire = "http_binary" if (t + i) % 2 == 0 else "fast"
                t0 = time.perf_counter()
                got = getattr(wires, wire)(model, pool[off:off + r])
                lat = time.perf_counter() - t0
                err = float(np.abs(got - ref64_pool[off:off + r]).max())
                keep = got if i % 10 == 0 else None
                results[t].append((wire, r, off, lat, err, keep))
        except BaseException as e:  # noqa: BLE001 - reported by the main thread
            errors.append(e)
        finally:
            if wires is not None:
                wires.close()

    snap, seq = REGISTRY.snapshot(), TIMELINE.seq()
    t0 = time.perf_counter()
    pool_threads = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
    for th in pool_threads:
        th.start()
    for th in pool_threads:
        th.join(600)
    wall = time.perf_counter() - t0
    delta = REGISTRY.snapshot().delta(snap)
    if errors:
        raise errors[0]
    if any(th.is_alive() for th in pool_threads):
        raise AssertionError("mixed traffic did not finish in 600 s")
    flat = [x for r in results for x in r]
    if len(flat) != per_thread * threads:
        raise AssertionError(f"{len(flat)} of {per_thread * threads} mixed requests answered")
    rows_total = sum(x[1] for x in flat)
    max_err = max(x[4] for x in flat)
    sample = [x for x in flat if x[5] is not None]
    same = sum(
        np.array_equal(x[5], eager_at_bucket(entry.model, pool[x[2]:x[2] + x[1]],
                                             B.serve_bucket(x[1])))
        for x in sample
    )
    out = {
        "requests": len(flat), "threads": threads, "rows": rows_total, "wall_s": wall,
        "rows_per_s": rows_total / wall, "requests_per_s": len(flat) / wall,
        **_pcts([x[3] for x in flat]),
        "by_wire": {w: _pcts([x[3] for x in flat if x[0] == w]) for w in ("http_binary", "fast")},
        "max_abs_err_vs_f64": max_err, "tol": tol,
        "batches": delta.counter("serve.batches"),
        "batch_rows": delta.hist("serve.batch_rows").to_dict(),
        "queue_delay_us": delta.hist("serve.queue_delay_us").to_dict(),
        "server_latency": delta.hist("serve.latency").to_dict(),
        # the ring keeps the last TPU_ML_TIMELINE_EVENTS events: a sample
        "spans": span_breakdown(TIMELINE.events(since_seq=seq)),
        "joined_in_flight": delta.counter("serve.joined_in_flight"),
        "sampled": len(sample), "sampled_bitwise_equal_at_own_bucket": int(same),
        "captures": delta.counter("compile.graph_captures"),
        "cold_compiles": delta.counter("serve.cold_compiles"),
        "errors": delta.counter("serve.errors"),
    }
    if not max_err <= tol:
        raise AssertionError(f"mixed traffic error {max_err} > {tol}")
    if out["errors"] or out["captures"] or out["cold_compiles"]:
        raise AssertionError(f"mixed traffic: {out}")
    if not out["batches"] < out["requests"]:
        raise AssertionError(f"no coalescing: {out['batches']} dispatches for {out['requests']}")
    return out


def serve_paging(device: torch.device, model_a, model_b, pool: np.ndarray, requests: int) -> dict:
    """Two models under an HBM budget that holds one; ``requests`` one-row
    requests alternate between them through the in-process client, so each
    pages the other out, and every answer is held bit for bit against the
    eager transform and to the f64 projection; then as many requests from
    four threads at once, each answer held to the f64 projection."""
    R.reset_for_tests()
    reg = R.ModelRegistry(device)
    budget = int(1.5 * 4 * model_a.pc.size)
    client = serve_client.ServeClient(registry=reg)
    try:
        with _env(TPU_ML_SERVE_HBM_BUDGET_BYTES=str(budget)):
            snap = REGISTRY.snapshot()
            reg.register("page_a", model_a)
            reg.register("page_b", model_b)
            b0 = B.serve_bucket(1)
            lat, max_rel, mismatched = [], 0.0, 0
            for i in range(requests):
                name = ("page_a", "page_b")[i % 2]
                entry = reg.get(name)
                rows = pool[i:i + 1]
                t0 = time.perf_counter()
                got = client.predict(name, rows)
                lat.append(time.perf_counter() - t0)
                mismatched += not np.array_equal(got, eager_at_bucket(entry.model, rows, b0))
                max_rel = max(max_rel, _rel_err(got, f64_projection(entry, rows)))

            # the same alternation from four threads at once, half through
            # the batcher and half direct, so page-outs land while other
            # threads replay: every answer to the f64 bound
            def hammer(t: int) -> float:
                worst = 0.0
                for i in range(requests // 4):
                    name = ("page_a", "page_b")[(i + t) % 2]
                    off = (t * requests + i) % (len(pool) - 3)
                    rows = pool[off:off + 1 + i % 3]
                    got = client.predict(name, rows) if i % 2 else reg.predict(name, rows)
                    worst = max(worst, _rel_err(got, f64_projection(reg.get(name), rows)))
                return worst

            with concurrent.futures.ThreadPoolExecutor(4) as workers:
                concurrent_rel = max(workers.map(hammer, range(4), timeout=600))
            delta = REGISTRY.snapshot().delta(snap)
            stats = hbm.get_fleet().stats()
    finally:
        client.close()
        R.reset_for_tests()
    page_in_s = delta.hist("compile.graph_capture_seconds", reason="page_in")
    out = {
        "budget_bytes": budget, "requests": requests, **_pcts(lat),
        "page_out": delta.counter("serve.page_out"), "page_in": delta.counter("serve.page_in"),
        "graph_recaptures": delta.counter("serve.graph_recaptures"),
        "recapture_s_total": page_in_s.total, "bitwise_mismatches": mismatched,
        "max_rel_err_vs_f64": max_rel, "concurrent_max_rel_err_vs_f64": concurrent_rel,
        "resident_bytes": stats["resident_bytes"],
    }
    if not (out["page_out"] > 0 and out["page_in"] > 0):
        raise AssertionError(f"the models did not page: {out}")
    if mismatched or not max(max_rel, concurrent_rel) <= SERVE_REL_TOL:
        raise AssertionError(f"paged answers wrong: {out}")
    return out


def _get_json(port: int, path: str) -> tuple[int, dict]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def serve_exporter_checks(fit_ids: tuple[str, ...]) -> dict:
    """Bring up the exporter and the health monitor; /healthz, /slo and
    /report answer with JSON, and /report holds the fits ``fit_ids``."""
    srv = httpd.start_http_server(0)
    try:
        out = {}
        for path in ("/healthz", "/slo", "/report"):
            code, body = _get_json(srv.port, path)
            out[path] = {"status": code, "keys": sorted(body)}
            if code != 200:
                raise AssertionError(f"{path} answered {code}: {body}")
            if path == "/healthz":
                out[path]["state"] = body["state"]
            if path == "/report":
                held = [r.get("fit_id") for r in body["reports"]]
                out[path]["fit_ids"] = [f for f in fit_ids if f in held]
    finally:
        httpd.stop_http_server()
    if out["/report"]["fit_ids"] != list(fit_ids):
        raise AssertionError(f"/report lacks phase 11's fits {fit_ids}: {out}")
    if out["/healthz"]["state"] not in ("OK", "DEGRADED"):
        raise AssertionError(f"/healthz: {out}")
    return out


# an objective no request can meet: a p50 latency of 1 ns
SHED_OBJECTIVE = "serve.latency:p50:1e-9"


def serve_shedding(srv, model: str, pool: np.ndarray, requests: int) -> dict:
    """Under ``SHED_OBJECTIVE`` and a monitor polling every 20 ms, one-row
    HTTP JSON requests (each on a connection of its own, 5 ms apart):
    under TPU_ML_ADMISSION_POLICY=refuse at least one answers 503 and
    ``serve.shed`` counts it; under off none does, though the objective
    burns all the same."""
    out = {}
    for policy in ("refuse", "off"):
        with _env(TPU_ML_ADMISSION_POLICY=policy):
            mon = health.start_monitor(interval_s=0.02, slo_engine=slo.SloEngine(
                slo.parse_objectives(SHED_OBJECTIVE), burn=1, window_s=60.0))
            snap = REGISTRY.snapshot()
            codes: dict[int, int] = {}
            try:
                for i in range(requests):
                    body = json.dumps({"instances": pool[i:i + 1].tolist()}).encode()
                    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
                    try:
                        conn.request("POST", f"/v1/models/{model}:predict", body=body,
                                     headers={"Content-Type": "application/json"})
                        resp = conn.getresponse()
                        resp.read()
                    finally:
                        conn.close()
                    codes[resp.status] = codes.get(resp.status, 0) + 1
                    time.sleep(0.005)
                breaches = mon.slo.total_breaches()
            finally:
                health.stop_monitor()
            shed = REGISTRY.snapshot().delta(snap).counter("serve.shed")
        out[policy] = {"codes": {str(c): v for c, v in sorted(codes.items())},
                       "slo_breaches": breaches, "serve_shed": shed}
    print(f"serving shedding: {json.dumps(out)}", flush=True)
    refuse, off = out["refuse"], out["off"]
    if not (refuse["codes"].get("503", 0) >= 1 and refuse["serve_shed"] > 0):
        raise AssertionError(f"no request shed under refuse: {out}")
    if set(refuse["codes"]) - {"200", "503"} or set(off["codes"]) != {"200"}:
        raise AssertionError(f"unexpected answers: {out}")
    if off["serve_shed"] != 0 or not off["slo_breaches"] > 0:
        raise AssertionError(f"shedding under off: {out}")
    return out


def phase_serving(model, std_model, device: torch.device, *, scaler_model=None,
                  report_fit_ids: tuple[str, ...] = (), latency_requests: int = 1000,
                  mixed_requests: int = 4000, threads: int = 16, paging_requests: int = 200,
                  shed_requests: int = 200, pool_rows: int = SERVE_POOL_ROWS,
                  reps: int = SERVE_TIMED_REPS, seed: int = 11) -> dict:
    """Register the servables (and phase 11's scaler, when given) over the
    whole ladder, check the exporter, check and time every rung, serve the
    traffic of the four wires and the mixed load, shed under an objective
    that cannot be met, then page two models under a budget (see the
    module note, phase 10)."""
    cuda = device.type == "cuda"
    n = model.pc.shape[0]
    pool = bench_workload(pool_rows, n, seed=seed)
    R.reset_for_tests()
    reg = R.ModelRegistry(device)
    ladder = B.bucket_ladder()
    snap = REGISTRY.snapshot()
    capture_s = {}
    served = [("pca512", model), ("pca512_std", std_model)]
    if scaler_model is not None:
        served.append(("scaler512", scaler_model))
    for name, m in served:
        t0 = time.perf_counter()
        reg.register(name, m)
        capture_s[name] = time.perf_counter() - t0
    # the bf16 variant is picked the way the JAX package picks it: by a
    # blessed entry in the tuning-cache file
    cache_dir = tempfile.mkdtemp(prefix="tuning")
    try:
        with _env(TPU_ML_TUNING_CACHE_PATH=os.path.join(cache_dir, "tuning.json")):
            tuning_cache.reset()
            tuning_cache.store(
                tuning_cache.cache_key("serve.pca", n=n, device=tuning_cache.device_kind(device)),
                TuningConfig(policy="bf16_f32acc"),
            )
            tuning_cache.reset()  # the registry reads the entry back from the file
            t0 = time.perf_counter()
            reg.register("pca512_bf16", model)
            capture_s["pca512_bf16"] = time.perf_counter() - t0
    finally:
        tuning_cache.reset()
        shutil.rmtree(cache_dir, ignore_errors=True)
    delta = REGISTRY.snapshot().delta(snap)
    policies = {name: reg.get(name).policy for name in reg.names()}
    expected_policies = {"pca512": "f32", "pca512_std": "f32", "pca512_bf16": "bf16_f32acc"}
    if scaler_model is not None:
        expected_policies["scaler512"] = "f32"
    if policies != expected_policies:
        raise AssertionError(f"serve policies {policies}")
    expected_captures = len(ladder) * len(expected_policies) if cuda else 0
    registration = {
        "ladder": list(ladder), "capture_s": capture_s,
        "aot_compiles": delta.counter("serve.aot_compiles"),
        "graph_captures": delta.counter("compile.graph_captures", reason="register"),
        "capture_s_per_graph": delta.hist("compile.graph_capture_seconds").to_dict(),
    }
    print(f"serving registration: {json.dumps(registration)}", flush=True)
    if registration["aot_compiles"] != expected_captures or (
        registration["graph_captures"] != expected_captures
    ):
        raise AssertionError(f"captures after registration {registration}, "
                             f"expected {expected_captures}")
    # before the rung checks, whose transforms would push the fits out of
    # /report's ring of recent reports
    exporter = serve_exporter_checks(report_fit_ids)
    print(f"serving exporter: {json.dumps(exporter)}", flush=True)
    rungs = serve_rung_checks(reg, device, pool, reps)
    for name, r in rungs.items():
        print(f"serving rungs {name}: {json.dumps(r)}", flush=True)

    uds_dir = tempfile.mkdtemp(prefix="serve")
    srv = S.start_serving(0, registry=reg, uds_path=_uds_path(uds_dir))
    try:
        latency = serve_latency_traffic(srv, reg, "pca512", pool, latency_requests, seed)
        print(f"serving latency: {json.dumps(latency)}", flush=True)
        mixed = serve_mixed_traffic(srv, reg, "pca512", pool, mixed_requests, threads, seed)
        print(f"serving mixed: {json.dumps(mixed)}", flush=True)
        alone = serve_batcher_alone(reg, "pca512", pool, min(latency_requests, 300))
        print(f"serving batcher alone: {json.dumps(alone)}", flush=True)
        summary = S.serve_summary(REGISTRY.snapshot().delta(snap))
        shedding = serve_shedding(srv, "pca512", pool, shed_requests)
    finally:
        S.stop_serving()
        shutil.rmtree(uds_dir, ignore_errors=True)
    paging = serve_paging(device, model, std_model, pool, paging_requests)
    print(f"serving paging: {json.dumps(paging)}", flush=True)
    return {"registration": registration, "exporter": exporter, "rungs": rungs,
            "latency": latency, "mixed": mixed, "batcher_alone": alone, "shedding": shedding,
            "paging": paging, "summary": summary}


# -- phase 12: BASELINE config 5 ---------------------------------------------

CONFIG5_ROWS = 50_000_000
CONFIG5_N = 128
CONFIG5_K = 1_000
CONFIG5_PARTITIONS = 12
CONFIG5_SEED = 21
# H100 SXM published dense f32 peak outside the tensor cores (NVIDIA data
# sheet), at the 700 W limit: the Lloyd step's two f32 products run there
# (TF32 is off).
PEAK_FP32_FLOPS = 67e12
# f32 sums and cost of a Lloyd pass against f64 on the same labels: 763
# blocks of 65,536 rows add into f32 accumulators one rounding (2⁻²⁴) each,
# and each block's sums come from one product: about 763·2⁻²⁴ = 4.5e-5 at
# worst, ~√763·2⁻²⁴ = 1.6e-6 typical. Gated normwise (sums) and relative
# (cost) at 1e-5.
KMEANS_RTOL = 1e-5
# int8_dist and bf16_f32acc rank by a coarser cross term, and how often
# their labels agree with f32 is a measurement, not a bound; a policy whose
# product were wrong would agree on about 1/k of the rows.
POLICY_AGREEMENT_FLOOR = 0.5


def f32_dist_error_bound(n: int) -> float:
    """Bound on |f32 − exact| of one expanded squared distance
    ‖x‖² + ‖c‖² − 2·x·c, relative to ‖x‖² + ‖c‖²: each of the two norms and
    the n-term dot product errs by at most γₙ ≈ n·2⁻²⁴ of its scale (Higham,
    §3.1), plus one rounding per add. Two distances whose f64 gap is under
    twice this can rank either way in f32: a near tie."""
    return 2.0 * (n + 2) * 2.0**-24


def partition_edges(rows: int, partitions: int) -> np.ndarray:
    """Row edges of ``np.array_split(x, partitions)``, the fit's split."""
    sizes = [rows // partitions + (i < rows % partitions) for i in range(partitions)]
    return np.concatenate([[0], np.cumsum(sizes)])


def kmeans_centres(k: int, n: int, device: torch.device, seed: int) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((k, n), generator=gen, device=device)


def kmeans_partition(p: int, edges: np.ndarray, centres: torch.Tensor, seed: int) -> torch.Tensor:
    """Partition ``p`` of the blobs, made on the centres' device from its own
    seed (so it is made again bit for bit): a uniform centre per row plus
    unit Gaussian noise."""
    device = centres.device
    gen = torch.Generator(device=device).manual_seed(seed + 1 + p)
    rows = int(edges[p + 1] - edges[p])
    labels = torch.randint(0, centres.shape[0], (rows,), generator=gen, device=device)
    x = centres[labels]
    x += torch.randn(x.shape, generator=gen, device=device)
    return x


def kmeans_workload(rows: int, n: int, k: int, partitions: int, device: torch.device,
                    seed: int = CONFIG5_SEED) -> np.ndarray:
    """The blobs as one host f32 matrix, made partition by partition on
    ``device``."""
    centres = kmeans_centres(k, n, device, seed)
    edges = partition_edges(rows, partitions)
    x = np.empty((rows, n), dtype=np.float32)
    for p in range(partitions):
        torch.from_numpy(x[edges[p]:edges[p + 1]]).copy_(kmeans_partition(p, edges, centres, seed))
    return x


def kmeans_device_parts(rows: int, n: int, k: int, partitions: int, device: torch.device,
                        seed: int = CONFIG5_SEED) -> list:
    """The same partitions made again on ``device``, each padded to its row
    bucket with a weight vector that masks the padding, as the fit holds
    them: [(x [bucket, n], w [bucket], true rows)]."""
    centres = kmeans_centres(k, n, device, seed)
    edges = partition_edges(rows, partitions)
    parts = []
    for p in range(partitions):
        m = int(edges[p + 1] - edges[p])
        bucket = columnar.bucket_rows(m)
        x = torch.zeros((bucket, n), dtype=torch.float32, device=device)
        x[:m] = kmeans_partition(p, edges, centres, seed)
        w = torch.zeros(bucket, dtype=torch.float32, device=device)
        w[:m] = 1.0
        parts.append((x, w, m))
    return parts


def kmeans_f64_pass(parts, centers: torch.Tensor, block: int, given=None,
                    compare: bool = True) -> dict:
    """Every true row assigned in f64 on the device: the f64 cost of
    ``centers``, and, with ``compare``, the f32 labels held to the f64 ones.
    The f32 labels are ``given`` (one int tensor per partition), else the
    Lloyd pass's own ``ops.kmeans.assign_clusters``; a row whose f64
    best/second-best gap is under twice ``f32_dist_error_bound`` may differ
    (a near tie), any other may not. Also the f64 sums and counts by the f32
    labels and the f64 counts by the f64 labels."""
    device = centers.device
    k, n = centers.shape
    c64 = centers.double()
    c_sq = (c64 * c64).sum(1)
    tie = 2.0 * f32_dist_error_bound(n)
    cost64 = torch.zeros((), dtype=torch.float64, device=device)
    sums64 = torch.zeros((k, n), dtype=torch.float64, device=device)
    counts_f32 = torch.zeros(k, dtype=torch.int64, device=device)
    counts_f64 = torch.zeros(k, dtype=torch.int64, device=device)
    tallies = torch.zeros(3, dtype=torch.int64, device=device)  # mismatch, near tie, bad
    labels_f32 = []
    for i, (x, _, rows) in enumerate(parts):
        part_labels = torch.empty(rows, dtype=torch.int64, device=device)
        # the Lloyd pass's own blocks, padding rows included (so the f32
        # products have its shapes), the padding masked out after
        for lo in range(0, rows, block):
            xb = x[lo:lo + block]
            m = min(block, rows - lo)
            x64 = xb[:m].double()
            x_sq = (x64 * x64).sum(1)
            d = (x_sq[:, None] + c_sq[None, :]) - 2.0 * (x64 @ c64.T)
            top = torch.topk(d, 2, dim=1, largest=False)
            cost64 += top.values[:, 0].clamp(min=0.0).sum()
            if not compare:
                continue
            lab64 = top.indices[:, 0]
            if given is None:
                lab32 = KM.assign_clusters(xb, centers)[0][:m]
            else:
                lab32 = given[i][lo:lo + m].long()
            part_labels[lo:lo + m] = lab32
            near = (top.values[:, 1] - top.values[:, 0]) < tie * (x_sq + c_sq.max())
            diff = lab32 != lab64
            tallies += torch.stack([diff.sum(), near.sum(), (diff & ~near).sum()])
            sums64.index_add_(0, lab32, x64)
            counts_f32 += torch.bincount(lab32, minlength=k)
            counts_f64 += torch.bincount(lab64, minlength=k)
        labels_f32.append(part_labels)
    mismatch, near, bad = (int(v) for v in tallies.cpu())
    return {
        "cost64": float(cost64), "sums64": sums64, "counts_f32_labels": counts_f32,
        "counts_f64_labels": counts_f64, "labels_f32": labels_f32 if compare else None,
        "mismatches": mismatch, "near_ties": near, "mismatches_not_near_tie": bad,
    }


def _lloyd_pass(parts, centers, block: int, policy: str):
    return tree_reduce(
        [KM.kmeans_stats(x, centers, w, block_rows=block, policy=policy) for x, w, _ in parts],
        KM.combine_kmeans_stats,
    )


def _lloyd_pass_s(parts, centers, block: int, device: torch.device, policy: str = "f32") -> float:
    """Wall seconds of one Lloyd accumulation pass over ``parts``, ended by a
    synchronise."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    _lloyd_pass(parts, centers, block, policy)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def lloyd_profile_ms(part, centers, block: int, device: torch.device) -> dict:
    """Device milliseconds by operator of one partition's Lloyd pass, from
    ``torch.profiler`` (the ten largest; empty without a card): which layer
    of the step (distance product, elementwise, argmin, one-hot product)
    takes the time."""
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return {}
    x, w, _ = part
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        KM.kmeans_stats(x, centers, w, block_rows=block)
        torch.cuda.synchronize(device)
    times = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if t:
            times[e.key] = t / 1e3
    return dict(sorted(times.items(), key=lambda kv: -kv[1])[:10])


def lloyd_bound_s(rows: int, n: int, k: int) -> tuple[float, str]:
    """Least time (s) an H100 needs for one Lloyd step: two f32 products of
    2·rows·n·k operations each (the cross term, then onehotᵀ·x) at the f32
    peak, against X read once."""
    ops_s = 4.0 * rows * n * k / PEAK_FP32_FLOPS
    bytes_s = 4.0 * rows * n / PEAK_HBM_BYTES_PER_S
    return max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s else "bytes")


def _mem_available() -> str:
    with open("/proc/meminfo") as f:
        return next((line.split(":", 1)[1].strip() for line in f
                     if line.startswith("MemAvailable")), "unknown")


def _fit_kmeans(x, k: int, partitions: int, device: torch.device, seed: int,
                init_mode: str, checkpoint_dir: str) -> tuple:
    """(model, wall seconds, iterations, the last iteration's input centres
    or None) of one fit through the public API with a checkpoint per
    iteration."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    model = KMeans(device=device, k=k, seed=seed, initMode=init_mode).fit(
        x, num_partitions=partitions, checkpoint_dir=checkpoint_dir)
    fit_s = time.perf_counter() - t0
    ckpt = TrainingCheckpointer(checkpoint_dir)
    steps = ckpt.steps()
    last_input = None
    if len(steps) > 1:
        last_input = torch.from_numpy(ckpt.load(steps[-2])[0]["centers"]).to(device)
    return model, fit_s, steps[-1] + 1, last_input


def _span_s(report, name: str) -> float:
    return float(report.phases.get(name, {}).get("sum", float("nan")))


def phase_config5(rows: int, n: int, k: int, partitions: int, device: torch.device,
                  seed: int = CONFIG5_SEED) -> dict:
    """BASELINE config 5 whole (see the module note, phase 12)."""
    cuda = device.type == "cuda"
    print(f"config 5: MemAvailable before the data: {_mem_available()}", flush=True)
    t0 = time.perf_counter()
    x = kmeans_workload(rows, n, k, partitions, device, seed)
    make_s = time.perf_counter() - t0
    result = {"rows": rows, "n": n, "k": k, "partitions": partitions, "make_data_s": make_s}

    with tempfile.TemporaryDirectory() as ck:
        model, fit_s, iters, last_input = _fit_kmeans(
            x, k, partitions, device, seed, "k-means++", os.path.join(ck, "pp"))
        model_par, fit_par_s, iters_par, _ = _fit_kmeans(
            x, k, partitions, device, seed, "k-means||", os.path.join(ck, "par"))
    report, report_par = model.fit_report, model_par.fit_report
    lloyd_s = _span_s(report, "kmeans lloyd")
    bound_s, bound_by = lloyd_bound_s(rows, n, k)
    result.update({
        "fit_s": fit_s, "iterations": iters,
        "init_span_s": _span_s(report, "kmeans init"), "lloyd_span_s": lloyd_s,
        "lloyd_s_per_iteration": lloyd_s / iters,
        "lloyd_bound_s": bound_s, "lloyd_bound_by": bound_by,
        "h2d_bytes": report.h2d_bytes, "peak_device_bytes": report.peak_device_bytes,
        "training_cost": model.trainingCost,
        "kmeans_par": {
            "fit_s": fit_par_s, "iterations": iters_par,
            "init_span_s": _span_s(report_par, "kmeans init"),
            "lloyd_span_s": _span_s(report_par, "kmeans lloyd"),
            "training_cost": model_par.trainingCost,
        },
    })
    print(f"config 5 fit report: {json.dumps(report.to_dict())}", flush=True)

    parts = kmeans_device_parts(rows, n, k, partitions, device, seed)
    block = block_rows_for(device, KM.DEFAULT_BLOCK_ROWS, k)
    est = KMeans(device=device, k=k, seed=seed)
    c_init = est._init_centers(np.array_split(x, partitions), k, None, parts)

    # one Lloyd step from the fit's initial centres against f64
    stats = _lloyd_pass(parts, c_init, block, "f32")
    step = kmeans_f64_pass(parts, c_init, block)
    counts32 = stats.counts.long()
    sums_err = float((stats.sums.double() - step["sums64"]).abs().max()
                     / step["sums64"].abs().max())
    cost_err = abs(float(stats.cost) - step["cost64"]) / step["cost64"]
    result["lloyd_step_vs_f64"] = {
        "mismatches": step["mismatches"], "near_ties": step["near_ties"],
        "mismatches_not_near_tie": step["mismatches_not_near_tie"],
        "counts_l1_vs_f64_labels": int((counts32 - step["counts_f64_labels"]).abs().sum()),
        "counts_equal_own_labels": bool(torch.equal(
            stats.counts, step["counts_f32_labels"].to(stats.counts.dtype))),
        "sums_normwise_err": sums_err, "cost_rel_err": cost_err, "rtol": KMEANS_RTOL,
    }

    # the Lloyd step at the default block against the card's
    times = {block: [], KM.DEFAULT_BLOCK_ROWS: []}
    for b in (block, KM.DEFAULT_BLOCK_ROWS, KM.DEFAULT_BLOCK_ROWS, block):
        times[b].append(_lloyd_pass_s(parts, c_init, b, device))
    small = _lloyd_pass(parts, c_init, KM.DEFAULT_BLOCK_ROWS, "f32")
    result["block_rows"] = {
        str(b): {"pass_s": ts, "min_pass_s": min(ts)} for b, ts in times.items()}
    result["block_rows"]["sums_normwise_diff"] = float(
        (small.sums - stats.sums).abs().max() / stats.sums.abs().max())
    result["block_rows"]["counts_l1_diff"] = int(
        (small.counts.long() - counts32).abs().sum())
    result["lloyd_profile_ms_one_partition"] = lloyd_profile_ms(parts[0], c_init, block, device)
    # the Lloyd passes keep the card busy (they wait on it once an
    # iteration); the copies, the seeding and the host's work leave it idle
    result["device_idle_share_est"] = 1.0 - iters * min(times[block]) / fit_s

    # one Lloyd pass under each coarser distance policy
    result["policies"] = {}
    for name in ("int8_dist", "bf16_f32acc"):
        with _env(TPU_ML_PRECISION_POLICY=name):
            policy = resolve_policy(None)
            pass_s = _lloyd_pass_s(parts, c_init, block, device, policy)
            agree = sum(
                int((KM.assign_blocks(xp[:m], c_init, block_rows=block, policy=policy)[0].long()
                     == lab).sum())
                for (xp, _, m), lab in zip(parts, step["labels_f32"]))
        result["policies"][name] = {"pass_s": pass_s, "label_agreement_vs_f32": agree / rows}
    del step

    # trainingCost: the cost of the last iteration's input centres
    pre = c_init if last_input is None else last_input
    cost64_pre = kmeans_f64_pass(parts, pre, block, compare=False)["cost64"]
    result["training_cost_rel_err_vs_f64"] = abs(model.trainingCost - cost64_pre) / cost64_pre

    # transform of every row, held to the f64 argmin of the fitted centres
    t0 = time.perf_counter()
    labels = model.transform(x)
    result["transform_s"] = time.perf_counter() - t0
    result["transform_span_s"] = _span_s(model.transform_report, "kmeans transform")
    edges = partition_edges(rows, partitions)
    given = [torch.from_numpy(labels[edges[p]:edges[p + 1]]).to(device)
             for p in range(partitions)]
    final = kmeans_f64_pass(parts, torch.from_numpy(model.clusterCenters).to(device), block,
                            given=given)
    result["transform_vs_f64"] = {
        "mismatches": final["mismatches"], "near_ties": final["near_ties"],
        "mismatches_not_near_tie": final["mismatches_not_near_tie"],
    }
    result["final_cost64"] = final["cost64"]
    del parts, given, final
    if cuda:
        torch.cuda.empty_cache()
    print(f"config 5: {json.dumps(result)}", flush=True)

    gate = result["lloyd_step_vs_f64"]
    if gate["mismatches_not_near_tie"]:
        raise AssertionError(f"config 5 Lloyd step labels off f64 beyond near ties: {gate}")
    if not gate["counts_l1_vs_f64_labels"] <= 2 * gate["mismatches"]:
        raise AssertionError(f"config 5 Lloyd step counts off f64: {gate}")
    if not gate["counts_equal_own_labels"]:
        raise AssertionError(f"config 5 Lloyd step counts are not those of its labels: {gate}")
    if not (sums_err <= KMEANS_RTOL and cost_err <= KMEANS_RTOL):
        raise AssertionError(f"config 5 Lloyd step sums or cost off f64: {gate}")
    if not result["block_rows"]["sums_normwise_diff"] <= KMEANS_RTOL:
        raise AssertionError(f"config 5 block sizes disagree: {result['block_rows']}")
    if not result["block_rows"]["counts_l1_diff"] <= 2 * gate["near_ties"]:
        raise AssertionError(f"config 5 block sizes disagree: {result['block_rows']}")
    for name, entry in result["policies"].items():
        if not entry["label_agreement_vs_f32"] >= POLICY_AGREEMENT_FLOOR:
            raise AssertionError(f"config 5 {name} labels agree with f32 on too few rows: {entry}")
    if not result["training_cost_rel_err_vs_f64"] <= KMEANS_RTOL:
        raise AssertionError(f"config 5 trainingCost off f64: {result}")
    if result["transform_vs_f64"]["mismatches_not_near_tie"]:
        raise AssertionError(f"config 5 transform labels off f64: {result['transform_vs_f64']}")
    if labels.shape != (rows,) or model.clusterCenters.shape != (k, n):
        raise AssertionError(f"config 5 shapes: labels {labels.shape}, "
                             f"centres {model.clusterCenters.shape}")
    for m in (model, model_par):
        if not (np.isfinite(m.clusterCenters).all() and np.isfinite(m.trainingCost)):
            raise AssertionError("config 5 fitted a non-finite model")
    if cuda and report.h2d_bytes < x.nbytes:
        raise AssertionError(f"config 5 fit copied {report.h2d_bytes} B, under the data's "
                             f"{x.nbytes}")
    return result


# -- phase 13: DBSCAN and exact kNN ------------------------------------------

DBSCAN_GRIDS = 250       # 250 grids of 20 x 20 points: 100,000 rows
DBSCAN_SIDE = 20
DBSCAN_NOISE_SHARE = 0.1  # rows moved off their grid to isolated places
DBSCAN_EPS = float(np.sqrt(1.5))  # squared: between the lattice's 1 and 2
DBSCAN_MIN_SAMPLES = 5    # an inner grid point and its 4 lattice neighbours
KNN_ROWS = 1_000_000      # the width and corpus size of SIFT-1M (ann-benchmarks)
KNN_QUERIES = 10_000
KNN_K = 10
KNN_RTOL = 1e-5
INT8_RECALL_FLOOR = 0.5


def dbscan_workload(grids: int, side: int, n: int, device: torch.device,
                    seed: int = 31) -> np.ndarray:
    """[grids·side², n] f32 rows: each grid a unit-spaced side × side
    lattice on a random 2-D plane through a random offset (σ = 5 per
    coordinate, so grids lie far apart and norms stay small enough for the
    f32 expansion), jittered by σ = 0.01; then a tenth of the rows moved to
    isolated random places (noise), which also breaks grids into pieces and
    turns some inner points into border points. Gaussian blobs in 128
    dimensions would not do: their pairwise distances concentrate, so no
    eps that splits them is far from every pair, and f32 and f64 would
    disagree on some eps decisions; a lattice's distances come in levels
    (1, 2, 4, …) with wide gaps between them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    frames = torch.linalg.qr(torch.randn((grids, n, 2), generator=gen, device=device))[0]
    offsets = 5.0 * torch.randn((grids, 1, n), generator=gen, device=device)
    ij = torch.stack(torch.meshgrid(
        torch.arange(side, device=device), torch.arange(side, device=device), indexing="ij"
    ), dim=-1).reshape(-1, 2).float() - (side - 1) / 2
    x = offsets + torch.einsum("pc,gnc->gpn", ij, frames)
    x = x.reshape(-1, n) + 0.01 * torch.randn((grids * side * side, n), generator=gen,
                                              device=device)
    moved = torch.randperm(x.shape[0], generator=gen, device=device)[
        : int(DBSCAN_NOISE_SHARE * x.shape[0])]
    x[moved] = 5.0 * torch.randn((len(moved), n), generator=gen, device=device)
    return x.cpu().numpy()


def dbscan_oracle_f64(x: np.ndarray, eps_sq: float, min_samples: float,
                      device: torch.device, block: int = 8192) -> tuple[np.ndarray, float]:
    """(labels, smallest relative gap |d² − eps²|/eps² over all pairs) of an
    f64 DBSCAN: the eps graph from f64 tiles on ``device``, connected
    components of the core points (scipy), each cluster named by its
    smallest core index, a border row taking the smallest such name among
    its core neighbours, then relabeled 0..C−1 in order; noise −1."""
    import scipy.sparse
    from scipy.sparse.csgraph import connected_components

    xd = torch.from_numpy(x).to(device, torch.float64)
    sq = (xd * xd).sum(1)
    rows_, cols_ = [], []
    gap = torch.tensor(float("inf"), dtype=torch.float64, device=device)
    for a in range(0, len(x), block):
        d = (sq[a:a + block, None] + sq[None, :]) - 2.0 * (xd[a:a + block] @ xd.T)
        gap = torch.minimum(gap, (d - eps_sq).abs().min())
        i, j = torch.nonzero(d <= eps_sq, as_tuple=True)
        rows_.append((i + a).cpu().numpy())
        cols_.append(j.cpu().numpy())
    i, j = np.concatenate(rows_), np.concatenate(cols_)  # self pairs included
    n = len(x)
    core = np.bincount(i, minlength=n) >= min_samples
    both = core[i] & core[j]
    graph = scipy.sparse.coo_matrix((np.ones(both.sum()), (i[both], j[both])), shape=(n, n))
    _, comp = connected_components(graph, directed=False)
    name = np.full(comp.max() + 1, n, dtype=np.int64)
    np.minimum.at(name, comp[core], np.flatnonzero(core))
    labels = np.where(core, name[comp], n)
    border = ~core[i] & core[j]
    np.minimum.at(labels, i[border], name[comp[j[border]]])
    labels = np.where(labels < n, labels, -1)
    ids = np.unique(labels[labels >= 0])
    out = np.full(n, -1, dtype=np.int32)
    out[labels >= 0] = np.searchsorted(ids, labels[labels >= 0])
    return out, float(gap) / eps_sq


def knn_f64(queries: torch.Tensor, corpus: torch.Tensor, k: int,
            chunk: int = 2048, block: int = 65_536) -> tuple[torch.Tensor, torch.Tensor]:
    """(squared distances, ids) of the k + 1 nearest corpus rows of every
    query, brute force in f64 on the device, ascending."""
    c64 = corpus.double()
    c_sq = (c64 * c64).sum(1)
    out_d, out_i = [], []
    for a in range(0, len(queries), chunk):
        q64 = queries[a:a + chunk].double()
        q_sq = (q64 * q64).sum(1)
        best_d = torch.empty((len(q64), 0), dtype=torch.float64, device=q64.device)
        best_i = torch.empty((len(q64), 0), dtype=torch.int64, device=q64.device)
        for b in range(0, len(corpus), block):
            d = (q_sq[:, None] + c_sq[None, b:b + block]) - 2.0 * (q64 @ c64[b:b + block].T)
            ids = torch.arange(b, b + d.shape[1], device=d.device).expand(len(q64), -1)
            d = torch.cat([best_d, d], dim=1)
            ids = torch.cat([best_i, ids], dim=1)
            best_d, which = torch.topk(d, k + 1, dim=1, largest=False)
            best_i = torch.gather(ids, 1, which)
        out_d.append(best_d)
        out_i.append(best_i)
    return torch.cat(out_d), torch.cat(out_i)


def knn_workload(rows: int, queries: int, n: int, device: torch.device,
                 seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(corpus, queries) of standard normal f32 rows on ``device``, from one
    seeded generator: phase 13's kNN data and phase 15's resident index."""
    gen = torch.Generator(device=device).manual_seed(seed)
    corpus = torch.randn((rows, n), generator=gen, device=device)
    return corpus, torch.randn((queries, n), generator=gen, device=device)


def _max_sq_norm(x: torch.Tensor, block: int = 1 << 20) -> float:
    """max ‖row‖² of ``x`` in f64, a block of rows at a time."""
    return max(float((x[a:a + block].double() ** 2).sum(1).max())
               for a in range(0, x.shape[0], block))


def knn_f64_gate(queries: torch.Tensor, corpus: torch.Tensor, ids: np.ndarray,
                 dist: np.ndarray, d64: torch.Tensor, k: int) -> dict:
    """How far returned neighbours (corpus positions ``ids``, euclidean
    ``dist``) stand from the exact f64 answer (``d64``, ascending squared
    distances from ``knn_f64``): the count of ids whose f64 squared distance
    exceeds the f64 k-th by more than the f32 near-tie bound
    (``f32_dist_error_bound``), and the largest relative error of a returned
    distance against its own f64 value."""
    n = queries.shape[1]
    ids_t = torch.from_numpy(np.ascontiguousarray(ids)).to(queries.device).long()
    q64 = queries.double()
    got64 = ((q64[:, None, :] - corpus[ids_t].double()) ** 2).sum(-1)
    tie = 2.0 * f32_dist_error_bound(n) * ((q64 * q64).sum(1, keepdim=True)
                                           + _max_sq_norm(corpus))
    outside = got64 > d64[:, k - 1:k] + tie  # not in the f64 top k, even up to a near tie
    exact = np.sqrt(got64.cpu().numpy())
    dist_err = np.abs(dist.astype(np.float64) - exact) / exact
    return {"ids_outside_f64_top_k": int(outside.sum()),
            "max_rel_dist_err": float(dist_err.max())}


def _timeline_spans(since_seq: int) -> dict:
    """Seconds per span name recorded since ``since_seq``."""
    spans: dict[str, float] = {}
    for e in TIMELINE.events(since_seq=since_seq):
        if "dur" in e:
            spans[e["name"]] = spans.get(e["name"], 0.0) + e["dur"] / 1e6
    return spans


def phase_distance_family(device: torch.device, *, grids: int = DBSCAN_GRIDS,
                          side: int = DBSCAN_SIDE, n: int = CONFIG5_N,
                          knn_rows: int = KNN_ROWS, knn_queries: int = KNN_QUERIES,
                          k: int = KNN_K, seed: int = 41) -> dict:
    """DBSCAN and exact kNN through the public API, each against an f64
    oracle made on the device (see the module note, phase 13)."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    result = {}
    x = dbscan_workload(grids, side, n, device)
    eps_sq = DBSCAN_EPS**2
    oracle, gap = dbscan_oracle_f64(x, eps_sq, DBSCAN_MIN_SAMPLES, device)
    norms = (x.astype(np.float64) ** 2).sum(1)
    f32_reach = f32_dist_error_bound(n) * 2.0 * norms.max() / eps_sq
    seq = TIMELINE.seq()
    sync()
    t0 = time.perf_counter()
    labels = DBSCAN(device=device, eps=DBSCAN_EPS, minSamples=DBSCAN_MIN_SAMPLES).fit() \
        .clusterLabels(x)
    sync()
    wall = time.perf_counter() - t0
    # one blocked pass alone (the core count): the clustering is a count
    # pass, one pass a propagation sweep and the border pass
    xd = torch.from_numpy(x).to(device)
    ones = torch.ones(len(x), device=device)
    t0 = time.perf_counter()
    DB.dbscan_core_mask(xd, ones, ones.bool(), float(np.float32(eps_sq)),
                        float(DBSCAN_MIN_SAMPLES),
                        block_rows=block_rows_for(device, DB.DEFAULT_BLOCK_ROWS))
    sync()
    one_pass = time.perf_counter() - t0
    del xd
    result["dbscan"] = {
        "rows": len(x), "n": n, "eps": DBSCAN_EPS, "min_samples": DBSCAN_MIN_SAMPLES,
        "wall_s": wall, "spans_s": _timeline_spans(seq),
        "one_pass_s": one_pass, "passes_est": wall / one_pass,
        "min_rel_gap_to_eps": gap, "f32_reach_rel": f32_reach,
        "clusters": int(oracle.max()) + 1, "noise_rows": int((oracle < 0).sum()),
        "label_mismatches": int((labels != oracle).sum()),
    }

    corpus, queries = knn_workload(knn_rows, knn_queries, n, device, seed)
    corpus_h, queries_h = corpus.cpu().numpy(), queries.cpu().numpy()
    d64, i64 = knn_f64(queries, corpus, k)
    seq = TIMELINE.seq()
    sync()
    t0 = time.perf_counter()
    model = NearestNeighbors(device=device, k=k).fit(corpus_h)
    dist, ids = model.kneighbors(queries_h)
    sync()
    wall = time.perf_counter() - t0
    gate = knn_f64_gate(queries, corpus, ids, dist, d64, k)
    id_mismatch = torch.from_numpy(ids).to(device) != i64[:, :k]
    int8_ids = torch.cat([
        NN.knn_topk(queries[a:a + 4096], corpus, torch.ones(knn_rows, dtype=torch.bool,
                                                             device=device), k,
                    policy="int8_dist")[1]
        for a in range(0, knn_queries, 4096)
    ]).long()
    recall = float((int8_ids[:, :, None] == i64[:, None, :k]).any(-1).float().mean())
    result["knn"] = {
        "corpus_rows": knn_rows, "queries": knn_queries, "n": n, "k": k,
        "wall_s": wall, "spans_s": _timeline_spans(seq),
        "id_mismatches": int(id_mismatch.sum()), **gate, "rtol": KNN_RTOL,
        "int8_dist_recall_at_k": recall,
    }
    print(f"distance family: {json.dumps(result)}", flush=True)

    db = result["dbscan"]
    if not db["min_rel_gap_to_eps"] > db["f32_reach_rel"]:
        raise AssertionError(f"DBSCAN eps within f32 reach of a pairwise distance: {db}")
    if db["label_mismatches"]:
        raise AssertionError(f"DBSCAN labels differ from the f64 oracle: {db}")
    if not (db["clusters"] > grids and db["noise_rows"] > 0):
        raise AssertionError(f"DBSCAN workload too plain to test: {db}")
    kn = result["knn"]
    if kn["ids_outside_f64_top_k"]:
        raise AssertionError(f"kNN ids outside the f64 top {k}: {kn}")
    if not kn["max_rel_dist_err"] <= KNN_RTOL:
        raise AssertionError(f"kNN distances off f64: {kn}")
    if not kn["int8_dist_recall_at_k"] >= INT8_RECALL_FLOOR:
        raise AssertionError(f"kNN int8_dist recall: {kn}")
    return result


# -- phase 14: the linear family ---------------------------------------------

LINEAR_SEED = 29
LOGREG_ROWS = 5_000_000    # binary LogisticRegression and LinearSVC, resident
SOFTMAX_ROWS = 1_000_000   # multinomial LogisticRegression, resident
SOFTMAX_CLASSES = 10
LINEAR_PARTITIONS = 8
NEWTON_REG = 0.01          # regParam of the Newton fits
ENET_REG, ENET_ALPHA = 1.0, 0.5
LINREG_NOISE = 0.5
LINEAR_CHUNK = 65_536
# The fold's XᵀX against f64, normwise: each chunk's f32 product sums
# 65,536 terms (≈ √65,536·2⁻²⁴ = 1.5e-5 of Σ|terms| a chunk, typical), and
# the chunks' errors add at random into the f64 carry: 1e-5 is several
# times the expected 1e-6.
LINEAR_STATS_RTOL = 1e-5
# Newton gates, against f64 passes over the same rows on the card: the
# gradient of the objective at the returned parameters, relative to its
# value at the zero start (the f32 products set a floor near 1e-6 of it),
# and the objective's excess over an f64 Newton from the same start.
NEWTON_GRAD_RTOL = 1e-4
NEWTON_OBJ_RTOL = 1e-6
INCREMENTAL_BATCHES_PCA, INCREMENTAL_BATCHES_LINREG = 8, 10
MINIBATCH_K, MINIBATCH_N, MINIBATCH_ROWS, MINIBATCH_BATCHES = 100, 128, 100_000, 10
MINIBATCH_RTOL = 1e-5


class _Killed(RuntimeError):
    """A fit stopped from outside, as a preempted worker stops."""


@contextlib.contextmanager
def _counted(module, name: str, fail_at: int | None = None):
    """Count the calls of ``module.name`` (a statistics function the fits
    look up at call time) and, with ``fail_at``, raise ``_Killed`` at that
    call."""
    real = getattr(module, name)
    calls = [0]

    def wrapper(*args, **kwargs):
        calls[0] += 1
        if fail_at is not None and calls[0] == fail_at:
            raise _Killed(f"{name}: the fit is killed at call {fail_at}")
        return real(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def linreg_workload(x: np.ndarray, device: torch.device, seed: int = LINEAR_SEED,
                    chunk: int = LINEAR_CHUNK) -> dict:
    """The label y = x·β + b + noise (f32, made on the card from the seed a
    chunk at a time), instance weights uniform on [0.5, 1.5] (f64), and
    β and b."""
    rows, n = x.shape
    gen = torch.Generator(device=device).manual_seed(seed)
    beta = torch.randn(n, generator=gen, dtype=torch.float64, device=device)
    intercept = 3.0
    y = np.empty(rows, dtype=np.float32)
    for a in range(0, rows, chunk):
        xc = torch.from_numpy(x[a:a + chunk]).to(device).double()
        noise = LINREG_NOISE * torch.randn(xc.shape[0], generator=gen, dtype=torch.float64,
                                           device=device)
        torch.from_numpy(y[a:a + chunk]).copy_(xc @ beta + intercept + noise)
    w = np.random.default_rng(seed).uniform(0.5, 1.5, size=rows)
    return {"y": y, "w": w, "beta": beta.cpu().numpy(), "intercept": intercept}


def linear_stats_f64(x: np.ndarray, y: np.ndarray, w: np.ndarray | None,
                     device: torch.device, chunk: int = LINEAR_CHUNK):
    """(unweighted, weighted or None) ``LinearStats`` of the host rows in
    f64 on the card, a chunk at a time."""
    n = x.shape[1]

    def zeros():
        z = dict(dtype=torch.float64, device=device)
        return [torch.zeros((n, n), **z), torch.zeros(n, **z), torch.zeros(n, **z),
                torch.zeros((), **z), torch.zeros((), **z), torch.zeros((), **z)]

    plain, weighted = zeros(), zeros() if w is not None else None
    for a in range(0, x.shape[0], chunk):
        xc = torch.from_numpy(x[a:a + chunk]).to(device).double()
        yc = torch.from_numpy(y[a:a + chunk]).to(device).double()
        sides = [(plain, torch.ones_like(yc))]
        if weighted is not None:
            sides.append((weighted, torch.from_numpy(w[a:a + chunk]).to(device)))
        for acc, wc in sides:
            xw = xc * wc[:, None]
            acc[0] += xc.T @ xw
            acc[1] += xw.T @ yc
            acc[2] += xw.sum(dim=0)
            acc[3] += (wc * yc).sum()
            acc[4] += (wc * yc * yc).sum()
            acc[5] += wc.sum()
    return LIN.LinearStats(*plain), None if weighted is None else LIN.LinearStats(*weighted)


def _centred_f64(s) -> tuple:
    """(m, A, b, μ, ȳ) of f64 statistics: the centred normal equations."""
    s = LIN.as_f64(s)
    m = s.count
    mu, ybar = s.x_sum / m, s.y_sum / m
    return m, s.xtx - m * torch.outer(mu, mu), s.xty - m * mu * ybar, mu, ybar


def normal_solve_f64(s, reg: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """The f64 oracle of an intercepted ridge fit: (A + λmI)β = b on centred
    moments, solved by ``torch.linalg.solve``."""
    m, a, b, mu, ybar = _centred_f64(s)
    coef = torch.linalg.solve(a + reg * m * torch.eye(a.shape[0], dtype=a.dtype,
                                                      device=a.device), b)
    return coef, ybar - mu @ coef


def linreg_gates(carry, oracle, coef: np.ndarray, intercept: float,
                 stats_rtol: float | None = LINEAR_STATS_RTOL) -> dict:
    """A fit's coefficients against the f64 oracle of its statistics.

    ``carry`` is the fit's own f64 carry (the same fold run again), ``oracle``
    the f64 statistics. The fit solves A_c·β̂ = b_c exactly (in f64) where
    A_c, b_c are the carry's centred moments, so β̂ − β* = A_c⁻¹(δb − δA·β*)
    with δ = carry − oracle: ‖β̂ − β*‖ ≤ ‖A_c⁻¹‖·(‖δb‖ + ‖δA‖·‖β*‖), a bound
    set by the f32 products the run measured and by the data's
    conditioning, and the intercept's error follows from it. Gated: the
    carry's XᵀX within ``stats_rtol`` of f64 (normwise; None reports it
    only), β̂ and b̂ within that bound."""
    device = carry.xtx.device
    m_c, a_c, b_c, mu_c, ybar_c = _centred_f64(carry)
    m, a, b, mu, ybar = _centred_f64(oracle)
    coef_star, b0_star = normal_solve_f64(oracle)
    coef_t = torch.as_tensor(coef, dtype=torch.float64, device=device)
    evals = torch.linalg.eigvalsh(a_c)
    d_a = torch.linalg.matrix_norm(a_c - a, ord=2)
    d_b = torch.linalg.norm(b_c - b)
    beta_norm = torch.linalg.norm(coef_star)
    bound = float((d_b + d_a * beta_norm) / evals[0])
    err = float(torch.linalg.norm(coef_t - coef_star))
    b0_bound = float(abs(ybar_c - ybar) + torch.linalg.norm(mu_c) * bound
                     + torch.linalg.norm(mu_c - mu) * beta_norm)
    b0_err = abs(intercept - float(b0_star))
    stats_rel = float(torch.linalg.norm(carry.xtx.double() - oracle.xtx)
                      / torch.linalg.norm(oracle.xtx))
    out = {
        "xtx_rel_err": stats_rel,
        "coef_err": err, "coef_bound": bound,
        "coef_rel_err": err / float(beta_norm),
        "intercept_err": b0_err, "intercept_bound": b0_bound,
        "cond": float(evals[-1] / evals[0]),
    }
    if stats_rtol is not None and not stats_rel <= stats_rtol:
        raise AssertionError(f"the fold's XᵀX is off f64 by {stats_rel}: {out}")
    slack = 1e-9 * float(beta_norm)  # the f64 solves' own rounding
    if not err <= 1.01 * bound + slack or not b0_err <= 1.01 * b0_bound + slack:
        raise AssertionError(f"coefficients outside the perturbation bound: {out}")
    return out


def enet_kkt(s, coef: torch.Tensor, reg: float, alpha: float) -> float:
    """Largest violation of the elastic-net optimality conditions at
    ``coef`` on the f64 statistics ``s`` (intercepted, centred)."""
    m, a, b, _, _ = _centred_f64(s)
    lam1, lam2 = reg * alpha, reg * (1.0 - alpha)
    g = (a @ coef - b) / m + lam2 * coef
    on = coef != 0
    viol = torch.where(on, torch.abs(g + lam1 * torch.sign(coef)),
                       torch.clamp(torch.abs(g) - lam1, min=0.0))
    return float(viol.max())


def _fold_carry(x, y, w, partitions: int, device: torch.device, dtype=torch.float64):
    """The streamed fit's carry, folded again through the same public
    pieces (``labeled_partitions``, ``stream_fold``, ``linear_fold_step``)."""
    data = (x, y) if w is None else (x, y, w)
    parts = columnar.labeled_partitions(data, None, None, partitions)
    return ingest.stream_fold(
        iter(parts), LIN.linear_fold_step(), n=x.shape[1], label_col="y",
        init=LIN.init_linear_carry(x.shape[1], device, dtype), device=device,
    ).carry


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fold_busy_s(x: np.ndarray, device: torch.device, chunks: int,
                chunk: int = LINEAR_CHUNK) -> float:
    """Device seconds of ``chunks`` linear fold steps over one chunk held on
    the card (CUDA events; the host clock on the CPU): the card's busy
    time of a streamed fit's folds."""
    xd = torch.from_numpy(np.ascontiguousarray(x[:chunk])).to(device)
    yd = xd[:, 0].contiguous()
    wd = torch.ones_like(yd)
    carry = LIN.init_linear_carry(x.shape[1], device)
    step = LIN.linear_fold_step()
    step(carry, xd, yd, wd)
    _sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(chunks):
            step(carry, xd, yd, wd)
        return time.perf_counter() - t0
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(chunks):
        step(carry, xd, yd, wd)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / 1e3


def phase_streamed_linreg(data, partitions: int, device: torch.device,
                          seed: int = LINEAR_SEED) -> dict:
    """(a) LinearRegression on phase 8's streamed data: the fit streams
    above the cutover (labels and weights staged beside the rows); plain,
    weighted, and elastic net (FISTA on the same statistics), each held to
    its f64 oracle on the card; ``h2d_bytes`` exactly rows × (n + 2) × 4;
    and the same fold with an f32 carry, for the carry's dtype."""
    x, _ = data
    rows, n = x.shape
    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    work = linreg_workload(x, device, seed)
    y, w = work["y"], work["w"]
    oracle, oracle_w = linear_stats_f64(x, y, w, device)
    oracle_s = time.perf_counter() - t0
    result = {"rows": rows, "n": n, "oracle_s": oracle_s}
    models, carries = {}, {}
    for label, kw, fit_data, stats in (
        ("plain", {}, (x, y), oracle),
        ("weighted", {}, (x, y, w), oracle_w),
        ("elastic_net", dict(regParam=ENET_REG, elasticNetParam=ENET_ALPHA,
                             maxIter=20_000, tol=1e-12), (x, y), oracle),
    ):
        est = LinearRegression(device=device, **kw)
        _sync(device)
        t0 = time.perf_counter()
        model = est.fit(fit_data, num_partitions=partitions)
        _sync(device)
        fit_s = time.perf_counter() - t0
        rep, report = model.stream_report, model.fit_report
        if rep is None:
            raise AssertionError(f"{label}: the fit went resident instead of streaming")
        shipped = rows * (n + 2) * 4 if cuda else 0
        entry = {
            "fit_s": fit_s, "chunks": rep.chunks,
            "stats_span_s": _span_s(report, "linreg stats"),
            "solve_span_s": _span_s(report, "linreg solve"),
            "h2d_bytes": report.h2d_bytes, "overlap_fraction": report.overlap_fraction,
            "copy_overlapped": rep.copy_overlapped,
        }
        entry["fold_share"] = entry["stats_span_s"] / fit_s
        if report.h2d_bytes != shipped:
            raise AssertionError(f"{label}: h2d_bytes {report.h2d_bytes}, expected {shipped}")
        if rep.rows != rows or rep.chunks != -(-rows // ingest.stream_chunk_rows()):
            raise AssertionError(f"{label}: the fold did not take every row once: {rep}")
        _fit_report_gates(report, fit_s, rows, device)
        carry = _fold_carry(x, y, w if label == "weighted" else None, partitions, device)
        solved = LIN.solve_from_stats(carry, **est._solve_args())
        if not np.array_equal(solved[0].cpu().numpy(), model.coefficients):
            raise AssertionError(f"{label}: the fit's coefficients are not its own fold's")
        if label == "elastic_net":
            coef = torch.as_tensor(model.coefficients, device=device)
            entry["kkt_own_stats"] = enet_kkt(carry, coef, ENET_REG, ENET_ALPHA)
            entry["kkt_f64_stats"] = enet_kkt(stats, coef, ENET_REG, ENET_ALPHA)
            # ∇ of the oracle's smooth part differs from the carry's by
            # e = (δA·ŵ − δb)/m: a KKT violation on f64 is at most the own
            # one plus ‖e‖∞
            m_c, a_c, b_c, _, _ = _centred_f64(carry)
            m, a, b, _, _ = _centred_f64(stats)
            e = float(torch.abs(((a_c - a) @ coef - (b_c - b)) / m).max())
            entry["kkt_perturbation"] = e
            entry["nonzero"] = int(np.count_nonzero(model.coefficients))
            if not entry["kkt_own_stats"] <= 1e-3 * ENET_REG * ENET_ALPHA:
                raise AssertionError(f"FISTA did not converge: {entry}")
            if not entry["kkt_f64_stats"] <= entry["kkt_own_stats"] + 1.01 * e + 1e-12:
                raise AssertionError(f"elastic net off its f64 conditions: {entry}")
        else:
            entry.update(linreg_gates(carry, stats, model.coefficients, model.intercept))
        models[label] = model
        carries[label] = carry
        result[label] = entry
        print(f"linear (a) {label}: {json.dumps(entry)}", flush=True)
    # the carry's dtype: the same fold into an f32 carry, solved the same way
    carry32 = _fold_carry(x, y, None, partitions, device, dtype=torch.float32)
    coef32, _ = LIN.solve_from_stats(LIN.as_f64(carry32))
    coef_star, _ = normal_solve_f64(oracle)
    result["f32_carry_coef_rel_err"] = float(
        torch.linalg.norm(coef32 - coef_star) / torch.linalg.norm(coef_star))
    result["f32_carry_xtx_rel_err"] = float(
        torch.linalg.norm(carry32.xtx.double() - oracle.xtx) / torch.linalg.norm(oracle.xtx))
    busy = fold_busy_s(x, device, result["plain"]["chunks"])
    result["fold_device_s"] = busy
    result["idle_share"] = 1.0 - busy / result["plain"]["fit_s"]
    # the fold's least time: its f32 operations (2·rows·n·(n+1) for XᵀX and
    # Xᵀy) at the f32 peak, or X, y and w read once from HBM
    ops_s = 2.0 * rows * n * (n + 1) / PEAK_FP32_FLOPS
    bytes_s = 4.0 * rows * (n + 2) / PEAK_HBM_BYTES_PER_S
    result["fold_bound_s"], result["fold_bound_by"] = max(ops_s, bytes_s), (
        "operations" if ops_s >= bytes_s else "bytes")
    print(f"linear (a) streamed: {json.dumps({k: v for k, v in result.items() if not isinstance(v, dict)})}",
          flush=True)
    result["model"] = models["plain"]
    # phase 22 (a) reuses the labels, the weights, and the weighted fit's
    # carry and f64 oracle
    result.update(y=y, w=w, weighted_carry=carries["weighted"], weighted_oracle=oracle_w)
    return result


def _logistic_labels(xd: torch.Tensor, seed: int) -> np.ndarray:
    """0/1 labels of the rows on the card: a seeded direction scaled to a
    margin of standard deviation 2, plus logistic noise."""
    gen = torch.Generator(device=xd.device).manual_seed(seed)
    beta = torch.randn(xd.shape[1], generator=gen, device=xd.device)
    z = xd @ beta
    z = 2.0 * (z - z.mean()) / z.std()
    u = torch.rand(z.shape, generator=gen, device=xd.device).clamp(1e-7, 1 - 1e-7)
    return (z + torch.log(u / (1 - u)) > 0).double().cpu().numpy()


def _softmax_labels(xd: torch.Tensor, classes: int, seed: int) -> np.ndarray:
    """Class labels of the rows on the card: Gumbel-max over seeded logits
    scaled to a standard deviation of 2 a class."""
    gen = torch.Generator(device=xd.device).manual_seed(seed)
    b = torch.randn((xd.shape[1], classes), generator=gen, device=xd.device)
    z = xd @ b
    z = 2.0 * (z - z.mean(0)) / z.std(0)
    u = torch.rand(z.shape, generator=gen, device=xd.device).clamp(1e-7, 1 - 1e-7)
    return torch.argmax(z - torch.log(-torch.log(u)), dim=1).double().cpu().numpy()


def _augmented_chunks(xd: torch.Tensor, chunk: int = 1 << 19):
    for a in range(0, xd.shape[0], chunk):
        xc = xd[a:a + chunk].double()
        yield a, torch.cat([xc, torch.ones((xc.shape[0], 1), dtype=xc.dtype, device=xc.device)], 1)


def newton_f64(xd: torch.Tensor, y: torch.Tensor, w: torch.Tensor, reg: float,
               classes: int | None = None, hessian: bool = True):
    """(objective, gradient, Hessian or None) in f64 over the rows on the
    card: Σ log-loss + (λm/2)‖w‖² with the intercepts exempt, the binary
    (``classes`` None, w [d]) or the softmax model (w [C·d])."""
    m = xd.shape[0]
    d = xd.shape[1] + 1
    c = 1 if classes is None else classes
    wm = w.reshape(c, d)
    pen = torch.ones((c, d), dtype=torch.float64, device=xd.device)
    pen[:, -1] = 0.0
    obj = 0.5 * reg * m * float(torch.sum(pen * wm * wm))
    grad = torch.zeros((c, d), dtype=torch.float64, device=xd.device)
    hess = torch.zeros((c * d, c * d), dtype=torch.float64, device=xd.device) if hessian else None
    for a, xa in _augmented_chunks(xd):
        yc = y[a:a + xa.shape[0]]
        if classes is None:
            z = xa @ wm[0]
            p = torch.sigmoid(z)
            obj += float(torch.sum(torch.logaddexp(torch.zeros_like(z), z) - yc * z))
            grad[0] += xa.T @ (yc - p)
            if hessian:
                hess += xa.T @ (xa * (p * (1 - p))[:, None])
            continue
        logits = xa @ wm.T
        logz = torch.logsumexp(logits, dim=1)
        onehot = torch.nn.functional.one_hot(yc.long(), c).double()
        obj += float(torch.sum(logz - torch.sum(onehot * logits, dim=1)))
        p = torch.exp(logits - logz[:, None])
        grad += (onehot - p).T @ xa
        if hessian:
            for i in range(c):
                for j in range(i, c):
                    blk = xa.T @ (xa * (p[:, i] * (float(i == j) - p[:, j]))[:, None])
                    hess[i * d:(i + 1) * d, j * d:(j + 1) * d] += blk
                    if i != j:
                        hess[j * d:(j + 1) * d, i * d:(i + 1) * d] += blk.T
    grad = (grad - reg * m * pen * wm).reshape(-1)
    if hess is not None:
        hess += torch.diag(reg * m * pen.reshape(-1))
    return obj, grad, hess


def newton_oracle_f64(xd, y, reg: float, classes: int | None = None,
                      max_iter: int = 30) -> tuple[torch.Tensor, float, int]:
    """An f64 Newton from the zero start, to a step of 1e-10 relative:
    (parameters, objective, iterations). For softmax, a 1e-12·trace/d ridge
    makes the Hessian invertible along the class-shift direction (an equal
    shift of every intercept, which changes nothing), and each step's
    component there is removed, so the stop test reads the rest."""
    d = xd.shape[1] + 1
    w = torch.zeros((1 if classes is None else classes) * d, dtype=torch.float64,
                    device=xd.device)
    for it in range(max_iter):
        _, g, h = newton_f64(xd, y, w, reg, classes)
        h += 1e-12 * torch.trace(h) / h.shape[0] * torch.eye(h.shape[0], dtype=h.dtype,
                                                              device=h.device)
        step = torch.linalg.solve(h, g)
        if classes is not None:
            step = step.reshape(classes, d)
            step[:, -1] -= step[:, -1].mean()
            step = step.reshape(-1)
        w = w + step
        if float(torch.linalg.norm(step)) <= 1e-10 * max(float(torch.linalg.norm(w)), 1.0):
            break
    return w, newton_f64(xd, y, w, reg, classes, hessian=False)[0], it + 1


def _newton_params(model, classes: int | None) -> np.ndarray:
    if classes is None:
        return np.concatenate([model.coefficients, [model.intercept]])
    return np.concatenate([model.coefficientMatrix, model.interceptVector[:, None]], 1).reshape(-1)


def _fit_newton(est, data, partitions: int, device: torch.device, stats_name: str,
                span: str, **fit_kw) -> tuple:
    """(model, wall s, iterations, Newton span s) of one fit; iterations
    from the calls of its statistics function."""
    _sync(device)
    with _counted(LIN, stats_name) as calls:
        t0 = time.perf_counter()
        model = est.fit(data, num_partitions=partitions, **fit_kw)
        _sync(device)
        fit_s = time.perf_counter() - t0
    return model, fit_s, calls[0] // partitions, _span_s(model.fit_report, span)


def newton_gates(label: str, model, xd, y, classes, reg: float, obj_star: float) -> dict:
    """The f64 gradient at the fit's parameters against its value at zero,
    and the objective's excess over the f64 Newton's."""
    w = torch.as_tensor(_newton_params(model, classes), device=xd.device)
    obj, grad, _ = newton_f64(xd, y, w, reg, classes, hessian=False)
    _, grad0, _ = newton_f64(xd, y, torch.zeros_like(w), reg, classes, hessian=False)
    out = {
        "grad_rel": float(torch.linalg.norm(grad) / torch.linalg.norm(grad0)),
        "obj": obj, "obj_f64_newton": obj_star,
        "obj_excess_rel": (obj - obj_star) / abs(obj_star),
    }
    if not out["grad_rel"] <= NEWTON_GRAD_RTOL:
        raise AssertionError(f"{label}: f64 gradient at the fit {out}")
    if not out["obj_excess_rel"] <= NEWTON_OBJ_RTOL:
        raise AssertionError(f"{label}: objective above the f64 Newton's {out}")
    return out


def phase_newton_fits(x_pool: np.ndarray, device: torch.device, *, rows: int = LOGREG_ROWS,
                      softmax_rows: int = SOFTMAX_ROWS, classes: int = SOFTMAX_CLASSES,
                      partitions: int = LINEAR_PARTITIONS, seed: int = LINEAR_SEED) -> dict:
    """(b) binary LogisticRegression and LinearSVC on the first ``rows`` of
    phase 8's rows, resident in ``partitions``; a checkpointed fit killed
    at its fourth iteration and resumed; (c) multinomial LogisticRegression
    with ``classes`` classes on the first ``softmax_rows``. Each Newton fit
    is held to f64 passes over the same rows on the card."""
    n = x_pool.shape[1]
    d = n + 1
    result = {}
    x = x_pool[:rows]
    xd = torch.from_numpy(x).to(device)
    y = _logistic_labels(xd, seed)
    y_t = torch.from_numpy(y).to(device)
    t0 = time.perf_counter()
    w_star, obj_star, it_star = newton_oracle_f64(xd, y_t, NEWTON_REG)
    oracle_s = time.perf_counter() - t0
    bound_s = (2.0 * rows * d * d + 4.0 * rows * d) / PEAK_FP32_FLOPS
    for label, cls, stats_name, span in (
        ("logistic", LogisticRegression, "logistic_newton_stats", "logreg newton"),
        ("svc", LinearSVC, "svc_newton_stats", "svc newton"),
    ):
        est = cls(device=device, regParam=NEWTON_REG)
        model, fit_s, iters, newton_s = _fit_newton(est, (x, y), partitions, device,
                                                    stats_name, span)
        entry = {"rows": rows, "d": d, "fit_s": fit_s, "iterations": iters,
                 "newton_span_s": newton_s, "s_per_iteration": newton_s / max(iters, 1),
                 "iteration_bound_s": bound_s,
                 "h2d_bytes": model.fit_report.h2d_bytes}
        entry["bound_share"] = bound_s / entry["s_per_iteration"]
        _fit_report_gates(model.fit_report, fit_s, rows, device)
        if label == "logistic":
            entry.update(newton_gates(label, model, xd, y_t, None, NEWTON_REG, obj_star))
            entry.update({"f64_newton_iterations": it_star, "f64_newton_s": oracle_s})
            logistic = model
        else:
            # the squared hinge's f64 check: its own objective's gradient
            wv = torch.as_tensor(_newton_params(model, None), device=device)
            entry["grad_rel"] = svc_grad_rel_f64(xd, y_t, wv, NEWTON_REG)
            if not entry["grad_rel"] <= NEWTON_GRAD_RTOL:
                raise AssertionError(f"svc: f64 gradient at the fit {entry}")
        result[label] = entry
        print(f"linear (b) {label}: {json.dumps(entry)}", flush=True)

    # killed in its 3rd iteration (at its first partition's statistics),
    # then the same call again: it resumes from the 2nd iteration's
    # checkpoint
    ckpt_dir = tempfile.mkdtemp(prefix="newton")
    try:
        est = LogisticRegression(device=device, regParam=NEWTON_REG)
        with _counted(LIN, "logistic_newton_stats", fail_at=2 * partitions + 1):
            try:
                est.fit((x, y), num_partitions=partitions, checkpoint_dir=ckpt_dir,
                        checkpoint_every=1)
                raise AssertionError("the killed fit ran to its end")
            except _Killed:
                pass
        steps = TrainingCheckpointer(ckpt_dir).steps()
        resumed, _, resumed_iters, _ = _fit_newton(
            est, (x, y), partitions, device, "logistic_newton_stats", "logreg newton",
            checkpoint_dir=ckpt_dir, checkpoint_every=1)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    equal = bool(np.array_equal(resumed.coefficients, logistic.coefficients)
                 and resumed.intercept == logistic.intercept)
    result["resume"] = {"checkpoint_steps": steps, "resumed_iterations": resumed_iters,
                        "equal_to_uninterrupted": equal,
                        "max_abs_diff": float(np.abs(resumed.coefficients
                                                     - logistic.coefficients).max())}
    print(f"linear (b) resume: {json.dumps(result['resume'])}", flush=True)
    if steps != [0, 1] or resumed_iters != result["logistic"]["iterations"] - 2 or not equal:
        raise AssertionError(f"the resumed fit is not the uninterrupted one: {result['resume']}")
    del xd, y_t

    xs = x_pool[:softmax_rows]
    xd = torch.from_numpy(xs).to(device)
    ys = _softmax_labels(xd, classes, seed)
    ys_t = torch.from_numpy(ys).to(device)
    t0 = time.perf_counter()
    _, obj_star, it_star = newton_oracle_f64(xd, ys_t, NEWTON_REG, classes)
    oracle_s = time.perf_counter() - t0
    est = LogisticRegression(device=device, regParam=NEWTON_REG)
    model, fit_s, iters, newton_s = _fit_newton(est, (xs, ys), partitions, device,
                                                "softmax_newton_stats", "softmax newton")
    blocks = classes * (classes + 1) // 2
    entry = {"rows": softmax_rows, "classes": classes, "d": d, "fit_s": fit_s,
             "iterations": iters, "newton_span_s": newton_s,
             "s_per_iteration": newton_s / max(iters, 1), "block_products": blocks,
             "block_products_bound_s": blocks * 2.0 * softmax_rows * d * d / PEAK_FP32_FLOPS,
             "f64_newton_iterations": it_star, "f64_newton_s": oracle_s}
    entry.update(newton_gates("softmax", model, xd, ys_t, classes, NEWTON_REG, obj_star))
    _fit_report_gates(model.fit_report, fit_s, softmax_rows, device)
    result["softmax"] = entry
    print(f"linear (c) softmax: {json.dumps(entry)}", flush=True)
    return result


def svc_grad_rel_f64(xd: torch.Tensor, y: torch.Tensor, w: torch.Tensor, reg: float) -> float:
    """‖∇‖ of the squared-hinge objective Σ max(1 − ŷz, 0)² + (λm/2)‖w‖²
    (intercept exempt) at ``w``, relative to its value at zero, in f64."""
    m = xd.shape[0]
    pen = torch.ones_like(w)
    pen[-1] = 0.0

    def grad(wv):
        g = torch.zeros_like(wv)
        for a, xa in _augmented_chunks(xd):
            yy = 2.0 * y[a:a + xa.shape[0]] - 1.0
            margin = torch.clamp(1.0 - yy * (xa @ wv), min=0.0)
            g += xa.T @ (2.0 * yy * margin)
        return g - reg * m * pen * wv

    return float(torch.linalg.norm(grad(w)) / torch.linalg.norm(grad(torch.zeros_like(w))))


def phase_spectral_incremental(rows: int, n: int, k: int, partitions: int,
                               device: torch.device, kmeans: dict | None = None) -> dict:
    """(d) TruncatedSVD and IncrementalPCA on phase 4's rows at "highest"
    and "high": launches per fit (``fused_gram_moments`` a partition for
    TruncatedSVD, ``symmetric_gram_moments`` a batch for IncrementalPCA at
    "high"; none at "highest"), components against the f64 oracle, and
    IncrementalPCA over ``partitions`` batches against the one-shot fit;
    IncrementalLinearRegression over 10 batches against the one-shot fit,
    and IncrementalKMeans's mini-batch steps against f64 updates
    (``minibatch_kmeans_check``, its sizes overridden by ``kmeans``)."""
    cuda = device.type == "cuda"
    x = bench_workload(rows, n)
    scatter = scatter_f64(x, device)
    comps64, _ = oracle_from_scatter(scatter, k)
    sigma64 = np.sqrt(np.clip(np.linalg.eigvalsh(scatter)[::-1][:k], 0.0, None))
    result, launches_by_path = {}, {}
    batches = np.array_split(x, partitions)
    for precision in ("highest", "high"):
        kernel_n = partitions if (cuda and precision == "high") else 0
        reset_launches()
        _sync(device)
        t0 = time.perf_counter()
        tsvd = TruncatedSVD(device=device, k=k, precision=precision).fit(
            x, num_partitions=partitions)
        _sync(device)
        tsvd_s = time.perf_counter() - t0
        tsvd_launches = read_launches()
        reset_launches()
        inc = IncrementalPCA(device=device, k=k, precision=precision)
        t0 = time.perf_counter()
        for b in batches:
            inc.partial_fit(b)
        inc_model = inc.finalize()
        _sync(device)
        inc_s = time.perf_counter() - t0
        inc_launches = read_launches()
        one_shot = PCA(device=device, k=k, precision=precision).fit(x, num_partitions=partitions)
        entry = {
            "tsvd_fit_s": tsvd_s, "tsvd_launches": tsvd_launches,
            "tsvd_min_cos_vs_f64": _min_abs_cosine(tsvd.components, comps64),
            "tsvd_sigma_rel_err": float(np.abs(tsvd.singularValues / sigma64 - 1).max()),
            "incremental_pca_s": inc_s, "incremental_pca_launches": inc_launches,
            "incremental_pca_min_cos_vs_one_shot": _min_abs_cosine(inc_model.pc, one_shot.pc),
            "incremental_pca_min_cos_vs_f64": _min_abs_cosine(inc_model.pc, comps64),
            "incremental_pca_ev_rel_diff": float(np.abs(
                inc_model.explainedVariance / one_shot.explainedVariance - 1).max()),
        }
        result[precision] = entry
        launches_by_path[f"TruncatedSVD {precision}"] = tsvd_launches
        launches_by_path[f"IncrementalPCA {precision}"] = inc_launches
        print(f"linear (d) {precision}: {json.dumps(entry)}", flush=True)
        if tsvd_launches != expected_launches(gram_moments=kernel_n):
            raise AssertionError(f"TruncatedSVD {precision} launches {tsvd_launches}")
        if inc_launches != expected_launches(symmetric_gram_moments=kernel_n):
            raise AssertionError(f"IncrementalPCA {precision} launches {inc_launches}")
        for key in ("tsvd_min_cos_vs_f64", "incremental_pca_min_cos_vs_one_shot",
                    "incremental_pca_min_cos_vs_f64"):
            if not entry[key] >= COSINE_BAR:
                raise AssertionError(f"{precision}: {key} {entry[key]} < {COSINE_BAR}")
        if not entry["tsvd_sigma_rel_err"] <= 1e-4 or not entry["incremental_pca_ev_rel_diff"] <= 1e-4:
            raise AssertionError(f"{precision}: singular values off {entry}")
    print(f"linear family launches: {json.dumps(launches_by_path)}", flush=True)

    # IncrementalLinearRegression over 10 batches against the one-shot fit:
    # each solves the f64 normal equations of its own f32 products (over
    # other blocks of rows), so each is held to the f64 oracle by the bound
    # of its own statistics (``linreg_gates``), and the two differ by at
    # most the sum of their bounds
    y = linreg_workload(x, device, LINEAR_SEED + 1)["y"]
    oracle, _ = linear_stats_f64(x, y, None, device)
    parts = columnar.labeled_partitions((x, y), None, None, partitions)
    one = LinearRegression(device=device).fit((x, y), num_partitions=partitions)
    one_stats = tree_reduce([LIN.as_f64(LIN.linear_stats(to_device(px, device),
                                                         to_device(py, device)))
                             for px, py, _ in parts], LIN.combine_linear_stats)
    inc = IncrementalLinearRegression(device=device)
    edges = np.linspace(0, rows, INCREMENTAL_BATCHES_LINREG + 1).astype(int)
    for lo, hi in zip(edges[:-1], edges[1:]):
        inc.partial_fit((x[lo:hi], y[lo:hi]))
    inc_model = inc.finalize()
    if not np.array_equal(LIN.solve_from_stats(one_stats)[0].cpu().numpy(), one.coefficients):
        raise AssertionError("the one-shot fit's coefficients are not its statistics'")
    linreg = {"one_shot": linreg_gates(one_stats, oracle, one.coefficients, one.intercept),
              "incremental": linreg_gates(inc._acc, oracle, inc_model.coefficients,
                                          inc_model.intercept),
              "coef_diff": float(np.linalg.norm(inc_model.coefficients - one.coefficients)),
              "rows_seen": inc.n_rows_seen}
    linreg["coef_diff_bound"] = linreg["one_shot"]["coef_bound"] + linreg["incremental"]["coef_bound"]
    result["incremental_linreg"] = linreg
    print(f"linear (d) incremental linreg: {json.dumps(linreg)}", flush=True)
    if inc.n_rows_seen != rows or not linreg["coef_diff"] <= 1.01 * linreg["coef_diff_bound"]:
        raise AssertionError(f"IncrementalLinearRegression off the one-shot fit: {linreg}")

    result["incremental_kmeans"] = minibatch_kmeans_check(device, **(kmeans or {}))
    return result


def minibatch_kmeans_check(device: torch.device, *, k: int = MINIBATCH_K, n: int = MINIBATCH_N,
                           rows: int = MINIBATCH_ROWS, batches: int = MINIBATCH_BATCHES,
                           seed: int = LINEAR_SEED) -> dict:
    """IncrementalKMeans on blobs (``initMode="random"``, seeded from the
    first batch): each mini-batch step against the f64 update from the same
    centres (``kmeans_f64_pass``: the sums and counts in f64 by the labels
    the step's own f32 assignment gives, each label held to the f64 one up
    to near ties)."""
    centres = 10.0 * kmeans_centres(k, n, device, seed)
    edges = partition_edges(rows * batches, batches)
    block = block_rows_for(device, KM.DEFAULT_BLOCK_ROWS, k)
    est = IncrementalKMeans(device=device, k=k, initMode="random", seed=seed, seedRows=1)
    worst, near, bad = 0.0, 0, 0
    cum64 = torch.zeros(k, dtype=torch.float64, device=device)
    t0 = time.perf_counter()
    for p in range(batches):
        xb = kmeans_partition(p, edges, centres, seed)
        host = xb.cpu().numpy()
        before = est._centers
        est.partial_fit(host)
        if before is None:  # the first batch seeds, then steps from the seeds
            before = torch.from_numpy(host[np.random.default_rng(seed).choice(
                len(host), k, replace=False)]).to(device)
        ref = kmeans_f64_pass([(xb, None, xb.shape[0])], before, block)
        near += ref["near_ties"]
        bad += ref["mismatches_not_near_tie"]
        counts = ref["counts_f32_labels"].double()
        new_cum = cum64 + counts
        upd = (before.double() * cum64[:, None] + ref["sums64"]) / torch.where(
            new_cum > 0, new_cum, torch.ones_like(new_cum))[:, None]
        expected = torch.where((new_cum > 0)[:, None], upd, before.double())
        cum64 = new_cum
        worst = max(worst, float(torch.abs(est._centers.double() - expected).max()
                                 / torch.abs(expected).max()))
    out = {"batches": batches, "rows_per_batch": rows, "k": k,
           "max_rel_err_vs_f64_update": worst, "near_ties": near,
           "labels_off_f64_not_near_tie": bad, "s": time.perf_counter() - t0,
           "rows_seen": est.n_rows_seen}
    print(f"linear (d) incremental kmeans: {json.dumps(out)}", flush=True)
    if bad or not worst <= MINIBATCH_RTOL or est.n_rows_seen != rows * batches:
        raise AssertionError(f"mini-batch steps off the f64 update: {out}")
    return out


def phase_linear_serving(model, pool: np.ndarray, device: torch.device, reps: int = 20) -> dict:
    """(e) (a)'s LinearRegressionModel served: a CUDA graph per rung, each
    replay bit for bit the eager margin and within the f64 bound, then a
    one-row fast-lane request against f64."""
    R.reset_for_tests()
    reg = R.ModelRegistry(device)
    snap = REGISTRY.snapshot()
    reg.register("linreg512", model)
    captures = REGISTRY.snapshot().delta(snap).counter("serve.aot_compiles")
    ladder = B.bucket_ladder()
    if captures != (len(ladder) if device.type == "cuda" else 0):
        raise AssertionError(f"linear servable captured {captures} graphs for {len(ladder)} rungs")
    rungs = serve_rung_checks(reg, device, pool, reps)["linreg512"]
    uds_dir = tempfile.mkdtemp(prefix="serve")
    srv = S.start_serving(0, registry=reg, uds_path=_uds_path(uds_dir))
    wires = _Wires(srv)
    try:
        row = pool[:1]
        t0 = time.perf_counter()
        got = wires.fast("linreg512", row)
        fast_ms = (time.perf_counter() - t0) * 1e3
    finally:
        wires.close()
        S.stop_serving()
        shutil.rmtree(uds_dir, ignore_errors=True)
        R.reset_for_tests()
    ref = f64_projection(reg.get("linreg512"), row)
    err = _rel_err(np.asarray(got).reshape(-1), ref)
    out = {"rungs": len(rungs["rungs"]), "captures": captures,
           "fast_lane_ms": fast_ms, "fast_lane_rel_err_vs_f64": err,
           "replay_device_ms": {r["bucket"]: r.get("replay_device_ms") for r in rungs["rungs"]}}
    print(f"linear (e) serving: {json.dumps(out)}", flush=True)
    if not err <= SERVE_REL_TOL:
        raise AssertionError(f"fast-lane answer off f64: {out}")
    return out


# -- phase 15: approximate nearest neighbours --------------------------------

ANN_K = 10
ANN_MAX_ITER = 10
ANN_RECALL_NPROBE = 20
ANN_RECALL_FLOOR = 0.9  # tests/test_ivf.py's floor, reported beside the measurement
# nprobe == nlist gathers every list for each 128-query block, the whole
# index per block: the full-probe gate runs on the first 1,024 queries
ANN_FULL_PROBE_QUERIES = 1_024
ANN_STREAM_ROWS = 10_000_000  # SIFT-10M's corpus size (and SIFT's width, 128)
ANN_STREAM_CHUNK = 1_000_000
ANN_STREAM_CLUSTERS = 1_000   # natural clusters: about 3 IVF lists each
ANN_NPROBES = (1, 8, 20, 64)
ANN_LATENCY_QUERIES = 50
ANN_SERVE_REQUESTS = 200
ANN_SEED = 43


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _recall(got: np.ndarray, exact: np.ndarray) -> float:
    """Mean share of each row's exact neighbours among the returned ones."""
    k = exact.shape[1]
    hits = (got[:, :, None] == exact[:, None, :]).any(-1).sum()
    return float(hits) / (exact.shape[0] * k)


def _index_bytes(model) -> int:
    return int(sum(np.asarray(a).nbytes for a in (
        model.centroids, model.bucketItems, model.bucketIds, model.spillItems, model.spillIds)))


def phase_ann_resident(device: torch.device, *, rows: int = KNN_ROWS,
                       queries: int = KNN_QUERIES, n: int = CONFIG5_N, k: int = ANN_K,
                       full_probe_queries: int = ANN_FULL_PROBE_QUERIES,
                       nprobe: int = ANN_RECALL_NPROBE, seed: int = 41) -> dict:
    """(a) ApproximateNearestNeighbors on phase 13's corpus and queries
    (nlist auto, maxIter 10): the build by span; at nprobe == nlist the ids
    within the f64 top k up to the near-tie rule and the distances within
    rtol 1e-5; recall@k at ``nprobe`` against the f64 top k."""
    corpus, q = knn_workload(rows, queries, n, device, seed)
    corpus_h, q_h = corpus.cpu().numpy(), q.cpu().numpy()
    d64, i64 = knn_f64(q, corpus, k)
    seq = TIMELINE.seq()
    _sync(device)
    t0 = time.perf_counter()
    model = ApproximateNearestNeighbors(device=device, k=k, maxIter=ANN_MAX_ITER).fit(corpus_h)
    _sync(device)
    build_s = time.perf_counter() - t0
    spans = _timeline_spans(seq)
    nlist = model.centroids.shape[0]
    fq = min(full_probe_queries, queries)
    t0 = time.perf_counter()
    dist, ids = model._kneighbors_matrix(q_h[:fq], k, nlist)
    _sync(device)
    full_s = time.perf_counter() - t0
    gate = knn_f64_gate(q[:fq], corpus, ids, dist, d64[:fq], k)
    t0 = time.perf_counter()
    _, ids_p = model.kneighbors(q_h)
    _sync(device)
    search_s = time.perf_counter() - t0
    out = {
        "rows": rows, "n": n, "k": k, "nlist": nlist, "cap": int(model.bucketItems.shape[1]),
        "spill_rows": int((model.spillIds >= 0).sum()), "index_bytes": _index_bytes(model),
        "build_s": build_s,
        "build_spans_s": {
            "quantizer": spans.get("kmeans init", 0.0) + spans.get("kmeans lloyd", 0.0),
            "assign": spans.get("ivf assign", 0.0), "pack": spans.get("ivf pack", 0.0),
            "ivf_build": spans.get("ivf build", 0.0)},
        "full_probe": {"queries": fq, "s": full_s, **gate, "rtol": KNN_RTOL},
        "nprobe": nprobe, "queries": queries, "search_s": search_s,
        "queries_per_s": queries / search_s,
        f"recall_at_{k}": _recall(ids_p, i64[:, :k].cpu().numpy()),
        "jax_test_recall_floor": ANN_RECALL_FLOOR,
    }
    print(f"ann (a) resident: {json.dumps(out)}", flush=True)
    if out["full_probe"]["ids_outside_f64_top_k"]:
        raise AssertionError(f"full-probe ids outside the f64 top {k}: {out['full_probe']}")
    if not out["full_probe"]["max_rel_dist_err"] <= KNN_RTOL:
        raise AssertionError(f"full-probe distances off f64: {out['full_probe']}")
    return {**out, "model": model, "queries_h": q_h}


def ann_stream_workload(rows: int, chunk: int, n: int, clusters: int, queries: int,
                        device: torch.device, seed: int = ANN_SEED):
    """(host chunks of the corpus, host queries): seeded rows of a mixture
    of ``clusters`` unit-scale Gaussian clusters (centres standard normal,
    unit noise, so neighbouring clusters overlap), made on ``device`` a
    chunk at a time and kept on the host; the queries are fresh rows of the
    same mixture."""
    gen = torch.Generator(device=device).manual_seed(seed)
    centres = torch.randn((clusters, n), generator=gen, device=device)

    def draw(m: int) -> np.ndarray:
        labels = torch.randint(0, clusters, (m,), generator=gen, device=device)
        return (centres[labels] + torch.randn((m, n), generator=gen, device=device)).cpu().numpy()

    chunks = [draw(min(chunk, rows - lo)) for lo in range(0, rows, chunk)]
    return chunks, draw(queries)


def _one_row_latency(fn, rows: np.ndarray) -> dict:
    lat = []
    for i in range(rows.shape[0]):
        t0 = time.perf_counter()
        fn(rows[i:i + 1])
        lat.append(time.perf_counter() - t0)
    return _pcts(lat)


def phase_ann_streamed(device: torch.device, *, rows: int = ANN_STREAM_ROWS,
                       chunk: int = ANN_STREAM_CHUNK, n: int = CONFIG5_N,
                       clusters: int = ANN_STREAM_CLUSTERS, queries: int = KNN_QUERIES,
                       k: int = ANN_K, nprobes: tuple = ANN_NPROBES,
                       latency_queries: int = ANN_LATENCY_QUERIES, seed: int = ANN_SEED) -> dict:
    """(b) IVFFlatIndex streamed over the chunks of ``ann_stream_workload``:
    each pass's time, cap, spill fraction and index bytes; the streamed
    pack against ``build_ivf_buckets`` on the concatenated corpus from the
    same centroids (bucket ids bit for bit, the spill list the same rows as
    a set); recall@k at each nprobe against the port's exact
    NearestNeighbors over the same corpus (non-decreasing), with throughput
    and one-row latency."""
    from spark_rapids_ml_tpu_torch.ann.index import IVFFlatIndex, _assign
    from spark_rapids_ml_tpu_torch.ops import ivf as IVF

    chunks, q_h = ann_stream_workload(rows, chunk, n, clusters, queries, device, seed)
    seq = TIMELINE.seq()
    snap = REGISTRY.snapshot()
    _sync(device)
    t0 = time.perf_counter()
    est = IVFFlatIndex(device=device, k=k, maxIter=ANN_MAX_ITER, seed=seed)
    model = est.fit(chunks)
    _sync(device)
    build_s = time.perf_counter() - t0
    delta = REGISTRY.snapshot().delta(snap)
    events = [e for e in TIMELINE.events(since_seq=seq) if "dur" in e]

    def durs(name):
        return [e["dur"] / 1e6 for e in events if e["name"] == name]

    spans = _timeline_spans(seq)
    nlist = model.nlist
    spill = int((model.spillIds >= 0).sum())
    passes = {"sample_s": sum(durs("ann sample")), "init_s": sum(durs("ann init")),
              "lloyd_s": durs("ann lloyd"), "assign_s": sum(durs("ann assign")),
              "pack_s": spans.get("ann pack", 0.0) - spans.get("ann assign", 0.0)}

    # the streamed pack against the one-shot pack of the whole corpus
    corpus_h = np.concatenate(chunks)
    cd = to_device(model.centroids, device)
    labels = np.concatenate([_assign(c, cd)[0] for c in chunks])
    ref = IVF.build_ivf_buckets(corpus_h, labels, nlist)
    ids_equal = bool(np.array_equal(model.bucketIds, ref.bucket_ids))
    spill_same = set(model.spillIds[model.spillIds >= 0].tolist()) == set(
        ref.spill_ids[ref.spill_ids >= 0].tolist())
    del ref, labels

    t0 = time.perf_counter()
    exact_d, exact_ids = NearestNeighbors(device=device, k=k).fit(corpus_h).kneighbors(q_h)
    _sync(device)
    exact_s = time.perf_counter() - t0
    del corpus_h
    sweep = {}
    for p in nprobes:
        model.search(q_h[:128], nprobe=p)  # the device copy of the index, and warm-up
        _sync(device)
        t0 = time.perf_counter()
        _, ids = model.search(q_h, nprobe=p)
        _sync(device)
        s = time.perf_counter() - t0
        sweep[p] = {"recall": _recall(ids, exact_ids), "s": s, "queries_per_s": queries / s,
                    "one_row": _one_row_latency(lambda r: model.search(r, nprobe=p),
                                                q_h[:latency_queries])}
    recalls = [sweep[p]["recall"] for p in nprobes]
    out = {
        "rows": rows, "n": n, "chunks": len(chunks), "clusters": clusters, "k": k,
        "nlist": nlist, "cap": int(model.bucketItems.shape[1]),
        "mean_list_rows": rows / nlist, "spill_rows": spill, "spill_fraction": spill / rows,
        "cells_reseeded": delta.counter("ann.cells_reseeded", index=est.uid),
        "build_rows": delta.counter("ann.build_rows", index=est.uid),
        "index_bytes": _index_bytes(model), "build_s": build_s, "passes": passes,
        "pack_bucket_ids_equal": ids_equal, "pack_spill_same_rows": spill_same,
        "exact_knn_s": exact_s, "queries": queries,
        "nprobe": {str(p): v for p, v in sweep.items()},
    }
    print(f"ann (b) streamed: {json.dumps(out)}", flush=True)
    if not (ids_equal and spill_same):
        raise AssertionError(f"streamed pack differs from build_ivf_buckets: {out}")
    if out["build_rows"] != rows:
        raise AssertionError(f"ann.build_rows booked {out['build_rows']} of {rows}")
    if recalls != sorted(recalls):
        raise AssertionError(f"recall falls as nprobe grows: {recalls}")
    return out


def _ann_expected(entry, rows: np.ndarray) -> np.ndarray:
    """The eager kernel's packed answer for each one-row request (each
    dispatches alone at the smallest bucket), finalized."""
    b0 = B.serve_bucket(1)
    out = []
    for i in range(rows.shape[0]):
        padded, _ = B.pad_to_bucket(rows[i:i + 1], b0)
        raw = entry.kernel(entry.params, torch.from_numpy(padded).to(entry.device))
        out.append(entry.finalize(raw.cpu().numpy(), 1))
    return np.concatenate(out)


def phase_ann_serving(model, pool: np.ndarray, device: torch.device, *,
                      requests: int = ANN_SERVE_REQUESTS) -> dict:
    """(c) (a)'s index registered as the "ann" family: a CUDA graph per rung,
    each replay bit for bit the eager search of the same padded block; then
    ``requests`` one-row queries over HTTP ``/v1/indexes/<name>:query``
    (JSON), UDS (JSON, kind "query") and the fast lane (FLAG_QUERY), every
    answer the eager one bit for bit, and ``ann.queries`` counting each."""
    R.reset_for_tests()
    reg = R.ModelRegistry(device)
    snap = REGISTRY.snapshot()
    t0 = time.perf_counter()
    entry = reg.register("ann", model)
    register_s = time.perf_counter() - t0
    captures = REGISTRY.snapshot().delta(snap).counter("serve.aot_compiles")
    ladder = B.bucket_ladder()
    if captures != (len(ladder) if device.type == "cuda" else 0):
        raise AssertionError(f"ann servable captured {captures} graphs for {len(ladder)} rungs")
    rungs = {}
    for b in ladder:
        padded, _ = B.pad_to_bucket(pool[:b], b)
        served = reg.dispatch_padded(entry, padded, b)
        eager = entry.kernel(entry.params, torch.from_numpy(padded).to(device)).cpu().numpy()
        rungs[b] = bool(np.array_equal(served, eager))
    rows = pool[:requests]
    expected = _ann_expected(entry, rows)
    exp_d, exp_i = unpack_query_result(expected)
    uds_dir = tempfile.mkdtemp(prefix="serve")
    srv = S.start_serving(0, registry=reg, uds_path=_uds_path(uds_dir))
    wires = _Wires(srv)
    answers, lat = {}, {}
    try:
        def http_json(r):
            wires.http.request("POST", "/v1/indexes/ann:query",
                               body=json.dumps({"instances": r.tolist()}),
                               headers={"Content-Type": "application/json"})
            resp = wires.http.getresponse()
            body = json.loads(resp.read())
            if resp.status != 200:
                raise AssertionError(f"HTTP {resp.status}: {body}")
            return np.asarray(body["distances"]), np.asarray(body["ids"])

        def uds_json(r):
            raw = json.dumps({"model": "ann", "kind": "query", "wire": "json",
                              "instances": r.tolist()}).encode()
            wires.uds.sendall(len(raw).to_bytes(4, "big") + raw)
            m = int.from_bytes(_read_exact(wires.uds_r, 4), "big")
            resp = json.loads(_read_exact(wires.uds_r, m))
            if not resp["ok"]:
                raise AssertionError(f"UDS error: {resp}")
            return np.asarray(resp["distances"]), np.asarray(resp["ids"])

        def fast(r):
            wires.uds.sendall(FL.pack_request("ann", np.ascontiguousarray(r, np.float32),
                                              query=True))
            return unpack_query_result(FL.read_response(lambda m: _read_exact(wires.uds_r, m)))

        before = REGISTRY.snapshot()
        for name, call in (("http_json", http_json), ("uds_json", uds_json), ("fast", fast)):
            call(rows[:1])  # the connection's first request is not timed
            got_d, got_i, samples = [], [], []
            for i in range(requests):
                t0 = time.perf_counter()
                d, ids = call(rows[i:i + 1])
                samples.append(time.perf_counter() - t0)
                got_d.append(d)
                got_i.append(ids)
            lat[name] = _pcts(samples)
            answers[name] = {
                "id_mismatches": int((np.concatenate(got_i) != exp_i).sum()),
                # the fast lane's f32 wire rounds the f64 distances once
                "max_rel_dist_err": float(np.max(np.abs(np.concatenate(got_d) - exp_d)
                                                 / np.maximum(exp_d, 1e-30))),
            }
        queries_counted = REGISTRY.snapshot().delta(before).counter("ann.queries", index="ann")
    finally:
        wires.close()
        S.stop_serving()
        shutil.rmtree(uds_dir, ignore_errors=True)
        R.reset_for_tests()
    out = {"rungs": len(rungs), "captures": captures, "register_s": register_s,
           "rung_replay_bit_equal": rungs, "one_row_latency": lat, "answers": answers,
           "ann_queries_counted": queries_counted, "requests": 3 * (requests + 1)}
    print(f"ann (c) serving: {json.dumps(out)}", flush=True)
    if not all(rungs.values()):
        raise AssertionError(f"a rung's replay differs from the eager search: {rungs}")
    for name, a in answers.items():
        tol = 2.0**-24 if name == "fast" else 0.0
        if a["id_mismatches"] or not a["max_rel_dist_err"] <= tol:
            raise AssertionError(f"{name} answers differ from the eager search: {a}")
    if queries_counted != out["requests"]:
        raise AssertionError(f"ann.queries counted {queries_counted} of {out['requests']}")
    return out


# -- phase 16: trees and NaiveBayes ------------------------------------------

HIGGS_ROWS = 11_000_000   # UCI HIGGS: 11,000,000 rows of 28 features
HIGGS_N = 28
HIGGS_TEST_ROWS = 500_000  # HIGGS's own split: the last 500,000 rows are the test set
HIGGS_SEED = 47
FOREST_TREES = 20         # Spark's defaults: numTrees 20, maxDepth 5, maxBins 32
FOREST_DEPTH = 5
FOREST_BINS = 32
TREE_ROWS = 200_000
NB_ROWS = 2_000_000       # 20 Newsgroups' class count over a 1,024-term vocabulary
NB_N = 1_024
NB_CLASSES = 20
NB_PARTITIONS = 8
NB_PREDICT_ROWS = 200_000
NB_RTOL = 1e-5
UNIT_ROUNDOFF = 2.0**-24


def higgs_workload(rows: int, n: int, device: torch.device, seed: int = HIGGS_SEED):
    """(x, binary label, continuous target) on the host: standard normal f32
    features made on ``device`` (HIGGS's shape), a target that is nonlinear
    in the first six (products, a sine, a square) plus noise, and the label
    its sign."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((rows, n), generator=gen, device=device)
    z = (x[:, 0] * x[:, 1] + torch.sin(2.0 * x[:, 2]) + x[:, 3] ** 2 - 1.0
         + 0.5 * x[:, 4] * x[:, 5] + 0.5 * torch.randn(rows, generator=gen, device=device))
    return x.cpu().numpy(), (z > 0).double().cpu().numpy(), z.double().cpu().numpy()


def _bootstrap_weights(seed: int, trees: int, rows: int) -> np.ndarray:
    """The fit's Poisson(1) bootstrap counts, drawn as the fit draws them."""
    return np.random.default_rng(seed).poisson(1.0, size=(trees, rows)).astype(np.float32)


def _level_gains(hist: torch.Tensor, impurity: str, min_instances: float,
                 valid_f: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """(gain [F, nodes, B] with invalid splits at −inf, n-scaled impurity of
    each node [nodes]) of one level's histogram, by the build's rules."""
    left = FO._running_sums(hist)
    total = left[0, :, -1]
    right = total[None, :, None, :] - left
    imp_total = FO._impurity_n(total, impurity)
    gain = imp_total[None, :, None] - FO._impurity_n(left, impurity) - FO._impurity_n(right, impurity)
    n_l, n_r = FO._node_count(left, impurity), FO._node_count(right, impurity)
    ok = (n_l >= min_instances) & (n_r >= min_instances) & (gain > 1e-12)
    ok[:, :, -1] = False
    if valid_f is not None:
        ok &= valid_f.T[:, :, None]
    return torch.where(ok, gain, torch.full_like(gain, float("-inf"))), imp_total


def forest_split_gate(trees, binned_t: torch.Tensor, row_stats: torch.Tensor,
                      weights: np.ndarray, *, impurity: str, k_features: int, seed: int,
                      max_depth: int, n_bins: int, min_instances: float = 1.0,
                      stats64: torch.Tensor | None = None) -> dict:
    """Every split of every tree against f64 on the device. The rows are
    routed through the fitted tree (integer bins, exact); each level's
    histogram is rebuilt in f64 and, again, in f32; each node's feature
    subset is replayed from its tree's generator. A split passes when its
    f64 gain is within the node's near-tie bound of the f64 best split, a
    leaf when no f64 split beats 0 by more than it. The bound is four
    times the largest gain error that the rebuilt f32 histogram shows at
    that node (an f32 histogram of the same level sums in another atomic
    order, so its error is of the same size as the fit's) plus 16 unit
    roundoffs of the node's n-scaled impurity (the f32 gain arithmetic).
    Also times each level's f32 histogram. ``stats64`` (default the f32
    stats in f64) are the exact stats the f64 histograms sum: a boosting
    stage's residuals from the f64 ensemble."""
    device = binned_t.device
    n_trees = trees.feature.shape[0]
    n_feat = binned_t.shape[0]
    gens = PF.tree_generators(seed, n_trees, device)
    stats64 = row_stats.double() if stats64 is None else stats64
    violations, worst, checked = 0, 0.0, 0
    level_s = [0.0] * max_depth
    for t in range(n_trees):
        w = to_device(weights[t], device)
        feature = torch.from_numpy(trees.feature[t]).to(device)
        split_bin = torch.from_numpy(trees.split_bin[t]).to(device)
        node = torch.zeros(binned_t.shape[1], dtype=torch.int64, device=device)
        active = torch.ones(binned_t.shape[1], dtype=torch.bool, device=device)
        for d in range(max_depth):
            nodes = 2**d
            offset = nodes - 1
            valid_f = None
            if k_features < n_feat:
                g = torch.rand((nodes, n_feat), generator=gens[t], device=device)
                kth = torch.topk(g, k_features, dim=1).values[:, -1]
                valid_f = g >= kth[:, None]
            local = torch.clamp(node - offset, 0, nodes - 1)
            wa = torch.where(active, w, torch.zeros_like(w))
            _sync(device)
            t0 = time.perf_counter()
            hist32 = FO.level_histogram(binned_t, local, row_stats * wa[:, None], nodes, n_bins)
            _sync(device)
            level_s[d] += time.perf_counter() - t0
            hist64 = FO.level_histogram(binned_t, local, stats64 * wa.double()[:, None],
                                        nodes, n_bins)
            gain64, imp64 = _level_gains(hist64, impurity, min_instances, valid_f)
            gain32, _ = _level_gains(hist32.double(), impurity, min_instances, valid_f)
            both = torch.isfinite(gain64) & torch.isfinite(gain32)
            err = torch.where(both, (gain32 - gain64).abs(), torch.zeros_like(gain64))
            tol = 4.0 * err.amax(dim=(0, 2)) + 16.0 * UNIT_ROUNDOFF * imp64.abs()
            best64 = gain64.permute(1, 0, 2).reshape(nodes, -1).amax(dim=1)
            f = feature[offset:offset + nodes].long()
            b = split_bin[offset:offset + nodes].long()
            split = f >= 0
            chosen = gain64[f.clamp(min=0), torch.arange(nodes, device=device), b]
            shortfall = torch.where(split, best64 - chosen,
                                    torch.clamp(best64, min=0.0))
            populated = hist64[0].sum(dim=(1, 2)) > 0
            bad = populated & ((shortfall > tol) | (split & ~torch.isfinite(chosen)))
            violations += int(bad.sum())
            checked += int(populated.sum())
            ratio = torch.where(populated & torch.isfinite(shortfall),
                                shortfall / torch.clamp(tol, min=1e-300),
                                torch.zeros_like(shortfall))
            worst = max(worst, float(ratio.max()))
            row_split = active & split[local]
            row_bin = torch.gather(binned_t, 0, f.clamp(min=0)[local][None, :])[0]
            node = torch.where(row_split, 2 * node + 1 + (row_bin > b[local]).long(), node)
            active = row_split
    return {"nodes_checked": checked, "violations": violations,
            "worst_shortfall_over_bound": worst,
            "hist_ms_per_level": [1e3 * s / n_trees for s in level_s]}


def _forest_phase(est, x: np.ndarray, y: np.ndarray, train: int, device: torch.device, *,
                  classification: bool, gate_trees: int | None) -> dict:
    """One forest: fit on the first ``train`` rows, held-out quality on the
    rest, every split against f64 (``forest_split_gate``) on the first
    ``gate_trees`` trees (all by default)."""
    seq = TIMELINE.seq()
    _sync(device)
    t0 = time.perf_counter()
    model = est.fit((x[:train], y[:train]))
    _sync(device)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = model._predict_matrix(x[train:])
    predict_s = time.perf_counter() - t0
    if classification:
        quality = {"held_out_accuracy": float(np.mean(pred == y[train:]))}
    else:
        resid = pred - y[train:]
        quality = {"held_out_rmse": float(np.sqrt(np.mean(resid**2))),
                   "held_out_r2": float(1.0 - np.mean(resid**2) / np.var(y[train:]))}
    seed, n_trees, depth = est.getSeed(), est.getNumTrees(), est.getMaxDepth()
    bins = est.getMaxBins()
    edges = PF.quantile_bin_edges(x[:train], bins, seed)
    binned_t = PF.bin_on_device(to_device(x[:train], device), edges)
    row_stats = to_device(est._row_stats(y[:train]), device)
    k_feat = PF.subset_size(est.getOrDefault("featureSubsetStrategy"), x.shape[1],
                            classification=classification)
    g = gate_trees or n_trees
    trees = FO.TreeArrays(*(a[:g] for a in model.trees))
    gate = forest_split_gate(trees, binned_t, row_stats,
                             _bootstrap_weights(seed, n_trees, train)[:g],
                             impurity=est.getImpurity(), k_features=k_feat, seed=seed,
                             max_depth=depth, n_bins=bins)
    del binned_t, row_stats
    return {"model": model, "train_rows": train, "test_rows": len(x) - train,
            "trees": n_trees, "max_depth": depth, "bins": bins, "k_features": k_feat,
            "fit_s": fit_s, "forest_build_span_s": _timeline_spans(seq).get("forest build", 0.0),
            "fit_s_per_level": fit_s / (n_trees * (depth + 1)),
            "predict_s": predict_s, **quality, "split_gate": gate}


def phase_trees_nb(device: torch.device, *, rows: int = HIGGS_ROWS, n: int = HIGGS_N,
                   test_rows: int = HIGGS_TEST_ROWS, trees: int = FOREST_TREES,
                   depth: int = FOREST_DEPTH, bins: int = FOREST_BINS,
                   tree_rows: int = TREE_ROWS, gate_trees: int | None = None,
                   nb_rows: int = NB_ROWS, nb_n: int = NB_N, nb_classes: int = NB_CLASSES,
                   nb_predict_rows: int = NB_PREDICT_ROWS, seed: int = HIGGS_SEED,
                   data: tuple | None = None) -> dict:
    """Phase 16 on HIGGS-shaped rows (``data`` if given, else made here):
    (a) RandomForestClassifier and (b) RandomForestRegressor at Spark's
    defaults, each split against f64; (c) DecisionTreeClassifier (all
    features) on the first ``tree_rows`` rows, bit for bit its CPU build;
    (d) (a)'s forest served, each rung's replay bit for bit the eager
    descent and its votes the eager prediction; (e) gaussian NaiveBayes on
    the HIGGS rows and (f) multinomial on Poisson counts, statistics
    against f64 on the device."""
    x, y_cls, y_reg = higgs_workload(rows, n, device, seed) if data is None else data
    rows = len(x)
    train = rows - test_rows
    out = {}
    common = dict(device=device, numTrees=trees, maxDepth=depth, maxBins=bins, seed=seed)
    out["classifier"] = _forest_phase(RandomForestClassifier(**common), x, y_cls, train, device,
                                      classification=True, gate_trees=gate_trees)
    out["regressor"] = _forest_phase(RandomForestRegressor(**common), x, y_reg, train, device,
                                     classification=False, gate_trees=gate_trees)
    forest = out["classifier"]["model"]
    out["regressor"].pop("model")

    # (c) one tree of all features: the card's build is the CPU's, bit for bit
    rows_c = (x[:tree_rows], y_cls[:tree_rows])
    t0 = time.perf_counter()
    on_card = DecisionTreeClassifier(device=device, maxDepth=depth, maxBins=bins).fit(rows_c)
    _sync(device)
    card_s = time.perf_counter() - t0
    on_cpu = DecisionTreeClassifier(device="cpu", maxDepth=depth, maxBins=bins).fit(rows_c)
    out["decision_tree"] = {
        "rows": tree_rows, "fit_s": card_s, "depth": on_card.depth,
        "bit_equal_to_cpu": all(np.array_equal(a, b) for a, b in zip(on_card.trees, on_cpu.trees))
        and np.array_equal(on_card.thresholds, on_cpu.thresholds),
    }

    # (d) the forest servable
    R.reset_for_tests()
    reg = R.ModelRegistry(device)
    snap = REGISTRY.snapshot()
    entry = reg.register("forest", forest)
    captures = REGISTRY.snapshot().delta(snap).counter("serve.aot_compiles")
    rungs = {}
    pool = x[train:]
    for b in B.bucket_ladder():
        padded, _ = B.pad_to_bucket(pool[:b], b)
        served = reg.dispatch_padded(entry, padded, b)
        eager = entry.kernel(entry.params, torch.from_numpy(padded).to(device)).cpu().numpy()
        rungs[b] = bool(np.array_equal(served, eager)) and bool(np.array_equal(
            entry.finalize(served, b), forest._predict_matrix(padded)))
    R.reset_for_tests()
    out["forest_serving"] = {"captures": captures, "rungs_bit_equal": rungs}
    out["classifier"].pop("model")

    # (e) gaussian NaiveBayes on the HIGGS rows, (f) multinomial on counts
    out["nb_gaussian"] = nb_phase(x[:train], y_cls[:train], x[train:], y_cls[train:],
                                  "gaussian", device)
    del x, y_cls, y_reg
    counts, labels = nb_count_workload(nb_rows + nb_predict_rows, nb_n, nb_classes, device, seed)
    out["nb_multinomial"] = nb_phase(counts[:nb_rows], labels[:nb_rows], counts[nb_rows:],
                                     labels[nb_rows:], "multinomial", device)
    del counts, labels
    print(f"trees and naive bayes: {json.dumps(out)}", flush=True)

    for name in ("classifier", "regressor"):
        check_split_gate(name, out[name]["split_gate"])
    if not out["decision_tree"]["bit_equal_to_cpu"]:
        raise AssertionError(f"the card's tree differs from the CPU's: {out['decision_tree']}")
    if not all(rungs.values()) or captures != (len(rungs) if device.type == "cuda" else 0):
        raise AssertionError(f"forest servable: {out['forest_serving']}")
    for name in ("nb_gaussian", "nb_multinomial"):
        check_nb(name, out[name])
    return out


def check_split_gate(name: str, gate: dict) -> None:
    if gate["violations"] or not gate["nodes_checked"]:
        raise AssertionError(f"{name}: a split off the f64 best beyond its bound: {gate}")


def check_nb(name: str, nb: dict) -> None:
    if not (nb["max_stat_rel_err"] <= NB_RTOL and nb["max_param_rel_err"] <= NB_RTOL
            and nb["prediction_mismatches_beyond_near_ties"] == 0):
        raise AssertionError(f"{name} off f64: {nb}")


def nb_count_workload(rows: int, n: int, classes: int, device: torch.device, seed: int):
    """(counts, labels) on the host: per-class Poisson rates (log-normal
    around 0.3, so most counts are 0 or 1, as a document's term counts are)
    and a uniform class per row, drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    rates = torch.exp(0.8 * torch.randn((classes, n), generator=gen, device=device) - 1.2)
    labels = torch.randint(0, classes, (rows,), generator=gen, device=device)
    counts = torch.empty((rows, n), dtype=torch.float32, device="cpu")
    for a in range(0, rows, 1 << 18):
        lab = labels[a:a + (1 << 18)]
        counts[a:a + len(lab)] = torch.poisson(rates[lab], generator=gen).cpu()
    return counts.numpy(), labels.double().cpu().numpy()


def _nb_f64_stats(x: np.ndarray, y: np.ndarray, classes: int, device: torch.device,
                  mu: torch.Tensor | None = None, block: int = 1 << 17):
    """(counts, Σx, Σ|x|) per class in f64 on the device, or with ``mu`` the
    centred Σ(x − μ_class)² (and its own scale, the same sum)."""
    counts = torch.zeros(classes, dtype=torch.float64, device=device)
    sums = torch.zeros((classes, x.shape[1]), dtype=torch.float64, device=device)
    abs_sums = torch.zeros_like(sums)
    for a in range(0, len(x), block):
        xd = to_device(x[a:a + block], device).double()
        yd = torch.from_numpy(y[a:a + block]).to(device).long()
        onehot = torch.nn.functional.one_hot(yd, classes).double()
        counts += onehot.sum(0)
        v = xd if mu is None else (xd - mu[yd]) ** 2
        sums += onehot.T @ v
        abs_sums += onehot.T @ v.abs()
    return counts, sums, abs_sums


def nb_phase(x: np.ndarray, y: np.ndarray, x_test: np.ndarray, y_test: np.ndarray,
             model_type: str, device: torch.device, partitions: int = NB_PARTITIONS) -> dict:
    """A NaiveBayes fit in ``partitions`` partitions; its statistics (the
    ops the fit runs, on the same partitions) against f64 on the device,
    each sum relative to Σ|terms| of its cell; its parameters against those
    of the f64 statistics (θ relative to √σ² for the gaussian means);
    predictions on ``x_test`` equal to the f64 parameters' argmax wherever
    the f64 margin between the top two classes exceeds twice the largest
    raw-score difference of the row."""
    classes = int(y.max()) + 1
    _sync(device)
    t0 = time.perf_counter()
    model = NaiveBayes(device=device, modelType=model_type).fit((x, y), partitions)
    _sync(device)
    fit_s = time.perf_counter() - t0
    parts = [(to_device(a, device), to_device(b, device), torch.ones(len(a), device=device))
             for a, b in zip(np.array_split(x, partitions), np.array_split(y, partitions))]
    stats = tree_reduce([NBO.nb_stats(a, b, w, classes) for a, b, w in parts],
                        NBO.combine_nb_stats)
    c64, s64, a64 = _nb_f64_stats(x, y, classes, device)
    errs = [float(((stats.counts.double() - c64).abs() / c64.clamp(min=1)).max()),
            float(((stats.feat_sum.double() - s64).abs() / a64.clamp(min=1e-300)).max())]
    mu64 = s64 / c64.clamp(min=1)[:, None]
    lam = model.getSmoothing()
    pi64 = torch.log(c64 + lam) - torch.log(c64.sum() + lam * classes)
    if model_type == "gaussian":
        sq = tree_reduce([NBO.nb_centered_sq(a, b, w, to_device(model.theta, device), classes)
                          for a, b, w in parts], lambda p, q: p + q)
        _, sq64, _ = _nb_f64_stats(x, y, classes, device, mu=mu64)
        errs.append(float(((sq.double() - sq64).abs() / sq64.clamp(min=1e-300)).max()))
        var64 = torch.clamp(sq64 / c64.clamp(min=1)[:, None], min=1e-12)
        theta64 = mu64
        param_err = max(
            float(((torch.from_numpy(model.theta).to(device) - mu64).abs() / var64.sqrt()).max()),
            float(((torch.from_numpy(model.sigma).to(device) - var64).abs() / var64).max()))
        ref = NaiveBayesModel(pi=pi64.cpu().numpy(), theta=theta64.cpu().numpy(),
                              sigma=var64.cpu().numpy(), device=device)
    else:
        theta64 = torch.log(s64 + lam) - torch.log(s64.sum(1, keepdim=True) + lam * x.shape[1])
        param_err = float(((torch.from_numpy(model.theta).to(device) - theta64).abs()
                           / theta64.abs()).max())
        ref = NaiveBayesModel(pi=pi64.cpu().numpy(), theta=theta64.cpu().numpy(),
                              device=device)
    param_err = max(param_err, float(((torch.from_numpy(model.pi).to(device) - pi64).abs()
                                      / pi64.abs()).max()))
    ref._set(modelType=model_type)
    raw, raw64 = model._raw_scores(x_test), ref._raw_scores(x_test)
    top2 = np.sort(raw64, axis=1)[:, -2:]
    near = (top2[:, 1] - top2[:, 0]) <= 2.0 * np.abs(raw - raw64).max(axis=1)
    mismatch = np.argmax(raw, axis=1) != np.argmax(raw64, axis=1)
    return {"model_type": model_type, "rows": len(x), "features": x.shape[1],
            "classes": classes, "fit_s": fit_s, "max_stat_rel_err": max(errs),
            "max_param_rel_err": param_err, "test_rows": len(x_test),
            "prediction_mismatches": int(mismatch.sum()),
            "prediction_mismatches_beyond_near_ties": int((mismatch & ~near).sum()),
            "held_out_accuracy": float(np.mean(np.argmax(raw, axis=1) == y_test))}


# ---------------------------------------------------------------------------
# Phase 17: GBT, the MLP, FM, UMAP and OneVsRest
# ---------------------------------------------------------------------------

GBT_STAGES = 20           # Spark's GBT defaults: maxIter 20, maxDepth 5, maxBins 32, stepSize 0.1
GBT_DEPTH = 5
GBT_BINS = 32
GBT_STEP = 0.1
GBT_GATE_STAGES = (1, 2, 20)
GBT_F_RTOL = 1e-5
MNIST_ROWS = 70_000       # MNIST's size, width and class count (its pixels are not used)
MNIST_N = 784
MNIST_CLASSES = 10
MNIST_TEST_ROWS = 10_000
MNIST_SEED = 53
MNIST_CENTRE_SCALE = 0.12  # class means N(0, 0.12²) per feature
MNIST_RANK = 10           # each class varies along 10 directions of its own,
MNIST_FACTOR_SCALE = 0.12  # with N(0, 0.12²) loadings, plus
MNIST_NOISE = 0.9         # isotropic noise: 15-NN vote 0.97, a linear fit 0.91
MLP_LAYERS = (784, 300, 100, 10)  # LeCun et al. 1998's 300-100 net
MLP_MAX_ITER = 100
MLP_TOL = 1e-6
MLP_LOSS_RTOL = 1e-5
MLP_PARITY_ITERS = 5
MLP_PARITY_RTOL = 1e-4
FM_FACTORS = 8
FM_MAX_ITER = 100
FM_STEP = 0.01            # Spark's default stepSize is 1.0 (cut: see PERF.md)
FM_SCORE_RTOL = 1e-5
FM_LOSS_RTOL = 1e-5
FM_PARITY_STEPS = 10
FM_PARITY_ROWS = 1_000_000
FM_PARITY_RTOL = 1e-4
UMAP_K = 15
UMAP_KNN_SAMPLE = 2_000
UMAP_TRUST_SAMPLE = 5_000
UMAP_MASS_RTOL = 1e-4
UMAP_EPOCH_ATOL = 1e-4    # × max |y|


@contextlib.contextmanager
def _recorded(module, name: str):
    """Record every call of ``module.name`` (a function the fits look up
    at call time) as (args, result)."""
    real = getattr(module, name)
    calls = []

    def wrapper(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, out))
        return out

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def mnist_workload(rows: int, n: int, classes: int, device: torch.device,
                   seed: int = MNIST_SEED) -> tuple[np.ndarray, np.ndarray]:
    """(x [rows, n] f32, labels f64) on the host: a seeded mixture of
    ``classes`` Gaussians made on ``device`` (MNIST's shape and class
    count), each a mean, a rank-``MNIST_RANK`` covariance of its own and
    isotropic noise, so that the classes differ more by their subspaces
    than by their means (as digits do): trained on 5,000 of these rows, a
    15-NN vote scores about 0.97 and a least-squares linear fit 0.91."""
    gen = torch.Generator(device=device).manual_seed(seed)
    centres = MNIST_CENTRE_SCALE * torch.randn((classes, n), generator=gen, device=device)
    factors = MNIST_FACTOR_SCALE * torch.randn((classes, n, MNIST_RANK), generator=gen,
                                               device=device)
    labels = torch.randint(0, classes, (rows,), generator=gen, device=device)
    x = torch.empty((rows, n), device=device)
    for c in range(classes):
        at = torch.nonzero(labels == c)[:, 0]
        z = torch.randn((len(at), MNIST_RANK), generator=gen, device=device)
        x[at] = centres[c] + z @ factors[c].T
    x += MNIST_NOISE * torch.randn((rows, n), generator=gen, device=device)
    return x.cpu().numpy(), labels.double().cpu().numpy()


def _stage_tree(trees, m: int, device: torch.device, dtype=torch.float32) -> FO.TreeArrays:
    parts = [torch.from_numpy(np.ascontiguousarray(a[m])).to(device) for a in trees]
    parts[3] = parts[3].to(dtype)
    return FO.TreeArrays(*parts)


def gbt_f64_margins(model, binned_t: torch.Tensor, device: torch.device, stages: int):
    """[F before stage m in f64 for m < stages] and the f64 F after them:
    Σ treeWeights·(leaf mean in f64 of the card's f32 leaf stats), each row
    routed through the card's trees on its bins."""
    depth = int(np.log2(model.trees.feature.shape[1] + 1) - 1)
    F = torch.zeros(binned_t.shape[1], dtype=torch.float64, device=device)
    before = []
    for m in range(stages):
        before.append(F)
        leaf = FO.tree_apply_binned(_stage_tree(model.trees, m, device, torch.float64),
                                    binned_t, max_depth=depth)
        F = F + float(model.treeWeights[m]) * (
            leaf[:, 1] / torch.where(leaf[:, 0] > 0, leaf[:, 0], torch.ones_like(leaf[:, 0])))
    return before, F


def _gbt_phase(est, x: np.ndarray, y: np.ndarray, train: int, device: torch.device, *,
               classification: bool, gate_stages: tuple) -> dict:
    """One GBT: fit on the first ``train`` rows (the card's F after each
    stage recorded through the loss hook), held-out quality, the split gate
    on ``gate_stages`` (1-based) with each stage's residuals from the f64
    ensemble of the card's earlier trees, the final F against f64, the
    losses' order, and the serving registry's refusal."""
    stage_F = []
    loss = est._loss
    est._loss = lambda yt, F, w: (stage_F.append(F), loss(yt, F, w))[1]
    seq = TIMELINE.seq()
    _sync(device)
    t0 = time.perf_counter()
    try:
        model = est.fit((x[:train], y[:train]))
    finally:
        del est._loss
    _sync(device)
    fit_s = time.perf_counter() - t0
    boost_s = _timeline_spans(seq).get("gbt boost", 0.0)
    pred = model._predict_matrix(x[train:])
    if classification:
        quality = {"held_out_accuracy": float(np.mean(pred == y[train:]))}
    else:
        resid = pred - y[train:]
        quality = {"held_out_r2": float(1.0 - np.mean(resid**2) / np.var(y[train:]))}

    stages, depth, bins = est.getMaxIter(), est.getMaxDepth(), est.getMaxBins()
    edges = PF.quantile_bin_edges(x[:train], bins, est.getSeed())
    binned_t = PF.bin_on_device(to_device(x[:train], device), edges)
    before64, F64 = gbt_f64_margins(model, binned_t, device, stages)
    y32 = torch.from_numpy(est._targets(y[:train]).astype(np.float32)).to(device)
    y64 = y32.double()
    gates = {}
    for stage in gate_stages:
        m = stage - 1
        F32 = stage_F[m - 1] if m > 0 else torch.zeros_like(y32)
        r32, r64 = est._pseudo_residuals(y32, F32), est._pseudo_residuals(y64, before64[m])
        gates[stage] = forest_split_gate(
            FO.TreeArrays(*(a[m:m + 1] for a in model.trees)), binned_t,
            torch.stack([torch.ones_like(r32), r32, r32 * r32], dim=1),
            np.ones((1, train), np.float32), impurity="variance", k_features=x.shape[1],
            seed=est.getSeed(), max_depth=depth, n_bins=bins,
            stats64=torch.stack([torch.ones_like(r64), r64, r64 * r64], dim=1))
    f_err = float((stage_F[-1].double() - F64).abs().max() / F64.abs().max())
    losses = model.trainLosses
    # a pairwise sum of the rows' losses errs by about log2(rows) roundings
    loss_rtol = 2.0 * np.ceil(np.log2(train)) * UNIT_ROUNDOFF
    rises = int(np.sum(np.diff(losses) > loss_rtol * losses[:-1]))
    R.reset_for_tests()
    try:
        R.ModelRegistry(device).register("gbt", model)
        refused = False
    except TypeError:
        refused = True
    del binned_t, stage_F, before64
    return {"train_rows": train, "test_rows": len(x) - train, "stages": stages,
            "max_depth": depth, "bins": bins, "fit_s": fit_s, "gbt_boost_span_s": boost_s,
            "ms_per_stage": 1e3 * boost_s / stages, **quality,
            "train_losses": [float(v) for v in losses], "loss_rises_beyond_rounding": rises,
            "final_F_rel_err_vs_f64": f_err, "registry_refuses": refused,
            "split_gates": gates}


def phase_gbt(x: np.ndarray, y_cls: np.ndarray, y_reg: np.ndarray, train: int,
              device: torch.device, *, stages: int = GBT_STAGES, depth: int = GBT_DEPTH,
              bins: int = GBT_BINS, gate_stages: tuple = GBT_GATE_STAGES,
              seed: int = HIGGS_SEED) -> dict:
    """17 (a): GBTClassifier and GBTRegressor at Spark's defaults."""
    common = dict(device=device, maxDepth=depth, maxBins=bins, stepSize=GBT_STEP, seed=seed)
    out = {
        "classifier": _gbt_phase(GBTClassifier(**common).setMaxIter(stages), x, y_cls, train,
                                 device, classification=True, gate_stages=gate_stages),
        "regressor": _gbt_phase(GBTRegressor(**common).setMaxIter(stages), x, y_reg, train,
                                device, classification=False, gate_stages=gate_stages),
    }
    for name, r in out.items():
        for stage, gate in r["split_gates"].items():
            check_split_gate(f"gbt {name} stage {stage}", gate)
        if not r["final_F_rel_err_vs_f64"] <= GBT_F_RTOL:
            raise AssertionError(f"gbt {name}: the card's F off the f64 ensemble: {r}")
        if not r["registry_refuses"]:
            raise AssertionError(f"gbt {name}: the serving registry took a GBT model")
    if out["regressor"]["loss_rises_beyond_rounding"]:
        raise AssertionError(f"gbt regressor: its training loss rose: {out['regressor']}")
    return out


def mlp_loss_f64(weights: np.ndarray, x: np.ndarray, y: np.ndarray, layers: tuple) -> float:
    """The mean softmax cross-entropy of the flat weights in f64 numpy."""
    h = x.astype(np.float64)
    at = 0
    for i, (fan_in, fan_out) in enumerate(zip(layers[:-1], layers[1:])):
        w = weights[at:at + fan_in * fan_out].astype(np.float64).reshape(fan_in, fan_out)
        at += fan_in * fan_out
        h = h @ w + weights[at:at + fan_out].astype(np.float64)
        at += fan_out
        if i < len(layers) - 2:
            h = 1.0 / (1.0 + np.exp(-h))
    shifted = h - h.max(axis=1, keepdims=True)
    lse = np.log(np.exp(shifted).sum(axis=1))
    return float(np.mean(lse - shifted[np.arange(len(y)), y.astype(np.int64)]))


def phase_mlp(x: np.ndarray, y: np.ndarray, train: int, device: torch.device, *,
              layers: tuple = MLP_LAYERS, max_iter: int = MLP_MAX_ITER,
              parity_iters: int = MLP_PARITY_ITERS, seed: int = MNIST_SEED) -> dict:
    """17 (b): MultilayerPerceptronClassifier (l-bfgs) on MNIST-shaped rows."""
    est = MultilayerPerceptronClassifier(device=device, layers=list(layers), maxIter=max_iter,
                                         tol=MLP_TOL, seed=seed)
    seq = TIMELINE.seq()
    _sync(device)
    t0 = time.perf_counter()
    model = est.fit((x[:train], y[:train]))
    _sync(device)
    fit_s = time.perf_counter() - t0
    train_s = _timeline_spans(seq).get("mlp train", 0.0)
    acc = float(np.mean(model._predict_matrix(x[train:]) == y[train:]))
    loss64 = mlp_loss_f64(model.weights, x[:train], y[:train], layers)
    # the first iterations from the fit's start, on the card and in f64 on the CPU
    flat0 = PMLP.glorot_init(layers, seed, device)
    steps = {}
    for name, dev, dt in (("card", device, torch.float32),
                          ("cpu_f64", torch.device("cpu"), torch.float64)):
        rec = []
        PMLP.train_mlp(flat0.to(dev, dt), torch.from_numpy(x[:train]).to(dev, dt),
                       torch.from_numpy(y[:train]).to(dev),
                       torch.ones(train, device=dev, dtype=dt), layers=layers,
                       solver="l-bfgs", max_iter=parity_iters, tol=MLP_TOL,
                       callback=lambda it, f, loss: rec.append(loss))
        steps[name] = rec
    step_err = float(np.max(np.abs(np.asarray(steps["card"]) - steps["cpu_f64"])
                            / np.abs(steps["cpu_f64"])))
    out = {"train_rows": train, "test_rows": len(x) - train, "layers": list(layers),
           "iterations": model.iterations, "fit_s": fit_s, "mlp_train_span_s": train_s,
           "s_per_iteration": train_s / max(model.iterations, 1), "held_out_accuracy": acc,
           "train_loss": model.trainLoss, "train_loss_f64": loss64,
           "train_loss_rel_err": abs(model.trainLoss - loss64) / abs(loss64),
           "first_losses": steps, "first_losses_max_rel_err": step_err}
    if not out["train_loss_rel_err"] <= MLP_LOSS_RTOL:
        raise AssertionError(f"mlp: trainLoss off the f64 loss at its weights: {out}")
    if not (len(steps["card"]) == parity_iters and step_err <= MLP_PARITY_RTOL):
        raise AssertionError(f"mlp: the card's first iterations off the CPU's f64: {out}")
    return out


def fm_score_f64(weights: np.ndarray, x: np.ndarray, n_feat: int, k: int,
                 chunk: int = 1 << 20) -> np.ndarray:
    """FM scores of the flat weights in f64 numpy, a chunk of rows at a time."""
    w = weights.astype(np.float64)
    b, lin, v = w[0], w[1:1 + n_feat], w[1 + n_feat:].reshape(n_feat, k)
    out = np.empty(len(x))
    for a in range(0, len(x), chunk):
        xc = x[a:a + chunk].astype(np.float64)
        xv = xc @ v
        out[a:a + chunk] = b + xc @ lin + 0.5 * np.sum(xv * xv - (xc * xc) @ (v * v), axis=1)
    return out


def fm_iteration_profile(model, x: np.ndarray, y: np.ndarray, device: torch.device, *,
                         classification: bool) -> dict:
    """One FM iteration's work (the loss and gradient, then the loss again)
    at the model's weights on ``x``: its wall milliseconds after a warm-up,
    the device milliseconds of its kernels by ``torch.profiler`` (each
    kernel once: an ``aten::`` operator's self device time is its kernels'
    again), and the eight largest kernels (empty without a card)."""
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return {}
    n_feat, k = x.shape[1], model.getFactorSize()
    xd = to_device(x, device)
    yd = torch.from_numpy(y.astype(np.float32)).to(device)
    wd = torch.ones(len(x), device=device)
    mask = PFM.param_mask(n_feat, k, fit_intercept=True, fit_linear=True,
                          dtype=torch.float32, device=device)
    flat = torch.from_numpy(model.flatWeights).to(device)

    def iteration():
        loss_fn = functools.partial(PFM.fm_loss, x=xd, y=yd, w=wd, mask=mask, n_feat=n_feat,
                                    k=k, classification=classification, l2=0.0)
        OPT.value_and_grad(loss_fn, flat)
        loss_fn(flat).item()

    iteration()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    iteration()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        iteration()
        torch.cuda.synchronize(device)
    times = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if t and not e.key.startswith("aten::"):
            times[e.key] = t / 1e3
    del xd
    return {"wall_ms": wall_ms, "device_ms": sum(times.values()),
            "top_ms": dict(sorted(times.items(), key=lambda kv: -kv[1])[:8])}


def _fm_phase(est, x: np.ndarray, y: np.ndarray, train: int, device: torch.device, *,
              classification: bool, parity_rows: int, parity_steps: int) -> dict:
    seq = TIMELINE.seq()
    _sync(device)
    t0 = time.perf_counter()
    model = est.fit((x[:train], y[:train]))
    _sync(device)
    fit_s = time.perf_counter() - t0
    train_s = _timeline_spans(seq).get("fm train", 0.0)
    n_feat, k = x.shape[1], est.getFactorSize()
    s32 = model._scores(x[train:])
    s64 = fm_score_f64(model.flatWeights, x[train:], n_feat, k)
    score_err = float(np.abs(s32 - s64).max() / np.abs(s64).max())
    if classification:
        quality = {"held_out_accuracy": float(np.mean((s32 > 0) == (y[train:] > 0.5)))}
    else:
        quality = {"held_out_r2": float(1.0 - np.mean((s32 - y[train:]) ** 2)
                                        / np.var(y[train:]))}
    mask = PFM.param_mask(n_feat, k, fit_intercept=True, fit_linear=True,
                          dtype=torch.float64, device=device)
    with torch.no_grad():
        x64 = to_device(x[:train], device).double()
        loss64 = float(PFM.fm_loss(torch.from_numpy(model.flatWeights).to(device).double(),
                                   x64, torch.from_numpy(y[:train]).to(device), 
                                   torch.ones(train, dtype=torch.float64, device=device), mask,
                                   n_feat=n_feat, k=k, classification=classification, l2=0.0))
        del x64
    # the first steps from the fit's start, on the card and in f64 on the CPU:
    # their losses are gated; their weights are reported (Adam divides each
    # gradient by its own scale, so a coordinate whose gradient is near 0
    # carries that gradient's f32 error, of a 1,000,000-row reduction, into
    # a full-sized step, where the loss is flat)
    flat0 = PFM.fm_init(n_feat, k, est.getOrDefault("initStd"), est.getOrDefault("seed"), device)
    steps, step_losses = {}, {}
    for name, dev, dt in (("card", device, torch.float32),
                          ("cpu_f64", torch.device("cpu"), torch.float64)):
        rec, losses = [], []
        PFM.train_fm(flat0.to(dev, dt), torch.from_numpy(x[:parity_rows]).to(dev, dt),
                     torch.from_numpy(y[:parity_rows]).to(dev, dt),
                     torch.ones(parity_rows, device=dev, dtype=dt), n_feat=n_feat, k=k,
                     solver="adamW", max_iter=parity_steps, classification=classification,
                     fit_intercept=True, fit_linear=True, step_size=est.getOrDefault("stepSize"),
                     tol=0.0, callback=lambda it, f, loss: (rec.append(f.double().cpu().numpy()),
                                                           losses.append(loss)))
        steps[name], step_losses[name] = np.stack(rec), np.asarray(losses)
    weight_err = float(np.abs(steps["card"] - steps["cpu_f64"]).max()
                       / np.abs(steps["cpu_f64"]).max())
    loss_err = float(np.max(np.abs(step_losses["card"] - step_losses["cpu_f64"])
                            / np.abs(step_losses["cpu_f64"])))
    return {"train_rows": train, "test_rows": len(x) - train, "factor_size": k,
            "step_size": est.getOrDefault("stepSize"), "iterations": model.iterations,
            "fit_s": fit_s, "fm_train_span_s": train_s,
            "s_per_iteration": train_s / max(model.iterations, 1), **quality,
            "held_out_score_rel_err_vs_f64": score_err, "train_loss": model.trainLoss,
            "train_loss_f64": loss64,
            "train_loss_rel_err": abs(model.trainLoss - loss64) / abs(loss64),
            "iteration_profile": fm_iteration_profile(model, x[:train], y[:train], device,
                                                      classification=classification),
            "parity_rows": parity_rows, "parity_steps": len(steps["card"]),
            "first_steps_loss_max_rel_err": loss_err,
            "first_steps_weights_max_err_over_max_weight": weight_err}


def phase_fm(x: np.ndarray, y_cls: np.ndarray, y_reg: np.ndarray, train: int,
             device: torch.device, *, max_iter: int = FM_MAX_ITER,
             parity_rows: int = FM_PARITY_ROWS, parity_steps: int = FM_PARITY_STEPS,
             seed: int = HIGGS_SEED) -> dict:
    """17 (c): FMClassifier and FMRegressor (adamW) on (a)'s rows."""
    common = dict(device=device, factorSize=FM_FACTORS, solver="adamW", maxIter=max_iter,
                  regParam=0.0, stepSize=FM_STEP, seed=seed)
    out = {
        "classifier": _fm_phase(FMClassifier(**common), x, y_cls, train, device,
                                classification=True, parity_rows=parity_rows,
                                parity_steps=parity_steps),
        "regressor": _fm_phase(FMRegressor(**common), x, y_reg, train, device,
                               classification=False, parity_rows=parity_rows,
                               parity_steps=parity_steps),
    }
    for name, r in out.items():
        if not (r["held_out_score_rel_err_vs_f64"] <= FM_SCORE_RTOL
                and r["train_loss_rel_err"] <= FM_LOSS_RTOL
                and r["parity_steps"] == parity_steps
                and r["first_steps_loss_max_rel_err"] <= FM_PARITY_RTOL):
            raise AssertionError(f"fm {name} off f64: {r}")
    return out


def trustworthiness(x: torch.Tensor, emb: torch.Tensor, k: int) -> float:
    """sklearn's trustworthiness of ``emb`` for ``x`` (rows on the device):
    1 − 2/(n·k·(2n − 3k − 1)) · Σ over each row's k embedded neighbours
    that are not among its k input neighbours of (input rank − k)."""
    n = x.shape[0]
    x64, e64 = x.double(), emb.double()
    d_x = torch.cdist(x64, x64)
    d_x.fill_diagonal_(float("inf"))
    ranks = torch.empty((n, n), dtype=torch.int64, device=x.device)
    order = torch.argsort(d_x, dim=1)
    ranks.scatter_(1, order, torch.arange(1, n + 1, device=x.device).expand(n, -1))
    d_e = torch.cdist(e64, e64)
    d_e.fill_diagonal_(float("inf"))
    nn_e = torch.topk(d_e, k, dim=1, largest=False).indices
    excess = torch.gather(ranks, 1, nn_e) - k
    t = float(excess[excess > 0].sum())
    return 1.0 - t * (2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0)))


def phase_umap(x: np.ndarray, y: np.ndarray, train: int, device: torch.device, *,
               k: int = UMAP_K, n_epochs: int = 0, knn_sample: int = UMAP_KNN_SAMPLE,
               trust_sample: int = UMAP_TRUST_SAMPLE, seed: int = MNIST_SEED) -> dict:
    """17 (d): UMAP at its defaults (``n_epochs`` 0: the auto rule) on (b)'s
    training rows, then transform of the held-out rows."""
    est = UMAP(device=device, nNeighbors=k, nEpochs=n_epochs, seed=seed)
    seq = TIMELINE.seq()
    with _recorded(PUMAP, "knn_graph") as knn_calls:
        _sync(device)
        t0 = time.perf_counter()
        model = est.fit(x[:train])
        _sync(device)
        fit_s = time.perf_counter() - t0
    spans = _timeline_spans(seq)
    t0 = time.perf_counter()
    emb_test = model._embed_matrix(x[train:])
    transform_s = time.perf_counter() - t0
    n_epochs = n_epochs or (500 if train < 10_000 else 200)

    # the graph: the fit's ids on a sample against the f64 top k + 1
    knn_d, knn_i = knn_calls[0][1]
    xd = to_device(x[:train], device)
    sample = np.random.default_rng(seed).choice(train, min(knn_sample, train), replace=False)
    queries = xd[torch.from_numpy(sample).to(device)]
    d64, _ = knn_f64(queries, xd, k + 1)
    knn_gate = knn_f64_gate(queries, xd, knn_i[sample, 1:], knn_d[sample, 1:],
                            d64[:, 1:], k)
    heads, tails, weights, rho, sigma = PUMAP.fuzzy_graph(knn_d[:, 1:], knn_i[:, 1:], device)
    kd = torch.from_numpy(np.ascontiguousarray(knn_d[:, 1:])).to(device).double()
    mass = torch.exp(-torch.clamp(kd - rho.double()[:, None], min=0.0)
                     / sigma.double()[:, None]).sum(1)
    # a row whose sigma sits at the floor (MIN_K_DIST_SCALE × mean distance)
    # does not solve the mass equation, by design
    floored = sigma <= UMO.MIN_K_DIST_SCALE * float(kd.mean()) * (1 + 1e-6)
    rel = (mass - np.log2(k)).abs() / np.log2(k)
    mass_err = float(rel[~floored].max()) if bool((~floored).any()) else 0.0
    heads_s, tails_s, weights_s = PUMAP.strong_edges(heads, tails, weights, n_epochs)
    heads_d, tails_d, eps = PUMAP.layout_edges(heads_s, tails_s, weights_s)

    # one layout epoch (epoch 1 of 2: no edge is due at epoch 0) on the card
    # against the CPU in f64, the same negatives
    a, b = float(np.float32(model.a)), float(np.float32(model.b))
    hd = torch.from_numpy(heads_d.astype(np.int64))
    td = torch.from_numpy(tails_d.astype(np.int64))
    neg = torch.randint(0, train, (len(heads_d), 5),
                        generator=torch.Generator(device=device).manual_seed(seed), device=device)
    layouts = {}
    for name, dev, dt in (("card", device, torch.float32),
                          ("cpu_f64", torch.device("cpu"), torch.float64)):
        negd = neg.to(dev)
        layouts[name] = UMO.optimize_layout(
            torch.from_numpy(model.embedding_).to(dev, dt), hd.to(dev), td.to(dev),
            torch.from_numpy(eps).to(dev, dt), a, b, n_epochs=2,
            neg_fn=lambda e, negd=negd: negd).double().cpu().numpy()
    epoch_err = float(np.abs(layouts["card"] - layouts["cpu_f64"]).max()
                      / np.abs(layouts["cpu_f64"]).max())

    # same seed, same layout? the whole schedule twice from one start, and
    # once more under torch's deterministic algorithms
    emb0 = to_device(model.embedding_, device)

    def layout():
        _sync(device)
        t = time.perf_counter()
        y_ = UMO.optimize_layout(emb0, hd.to(device), td.to(device), to_device(eps, device), a, b,
                                 n_epochs=n_epochs,
                                 generator=PUMAP.layout_generator(seed, device))
        _sync(device)
        return y_.cpu().numpy(), time.perf_counter() - t

    first, first_s = layout()
    second, _ = layout()
    deterministic = {}
    torch.use_deterministic_algorithms(True)
    try:
        third, third_s = layout()
        fourth, _ = layout()
        deterministic = {"bit_equal": bool(np.array_equal(third, fourth)),
                         "ms_per_epoch": 1e3 * third_s / n_epochs}
    except RuntimeError as err:
        deterministic = {"raised": str(err)[:200]}
    finally:
        torch.use_deterministic_algorithms(False)

    # structure, with no floor: trustworthiness@k on a sample, and the
    # held-out rows' k-NN label vote in the embedding
    ts = np.random.default_rng(seed + 1).choice(train, min(trust_sample, train), replace=False)
    tw = trustworthiness(xd[torch.from_numpy(ts).to(device)],
                         to_device(model.embedding_[ts], device), k)
    e_train = to_device(model.embedding_, device)
    e_test = to_device(emb_test, device)
    nn = torch.topk(torch.cdist(e_test, e_train), k, dim=1, largest=False).indices.cpu().numpy()
    votes = np.apply_along_axis(np.bincount, 1, y[:train][nn].astype(np.int64),
                                minlength=int(y.max()) + 1).argmax(1)
    del xd, queries
    out = {"train_rows": train, "test_rows": len(x) - train, "n_neighbors": k,
           "n_epochs": n_epochs, "fit_s": fit_s,
           "spans_s": {name: spans.get(name, 0.0) for name in
                       ("umap knn graph", "umap fuzzy graph", "umap init", "umap layout")},
           "ms_per_epoch": 1e3 * spans.get("umap layout", 0.0) / n_epochs,
           "transform_s": transform_s, "edges": int(len(heads)),
           "layout_edges": int(len(heads_d)), "knn_gate": knn_gate,
           "max_mass_rel_err": mass_err, "sigma_floored_rows": int(floored.sum()),
           "one_epoch_rel_err_vs_f64": epoch_err,
           "same_seed_bit_equal": bool(np.array_equal(first, second)),
           "same_seed_max_abs_diff": float(np.abs(first - second).max()),
           "layout_ms_per_epoch": 1e3 * first_s / n_epochs,
           "deterministic_algorithms": deterministic,
           "trustworthiness": tw, "held_out_knn_label_agreement": float(np.mean(votes == y[train:]))}
    if out["knn_gate"]["ids_outside_f64_top_k"]:
        raise AssertionError(f"umap: graph ids off the f64 top {k}: {out}")
    if not mass_err <= UMAP_MASS_RTOL:
        raise AssertionError(f"umap: a row's calibrated mass is off log2(k): {out}")
    if not epoch_err <= UMAP_EPOCH_ATOL:
        raise AssertionError(f"umap: the card's layout epoch is off the CPU's f64: {out}")
    if emb_test.shape != (len(x) - train, 2) or not np.isfinite(emb_test).all():
        raise AssertionError(f"umap: transform gave {emb_test.shape}, finite "
                             f"{np.isfinite(emb_test).all()}")
    return out


def phase_ovr(x: np.ndarray, y: np.ndarray, train: int, device: torch.device) -> dict:
    """17 (e): OneVsRest(LogisticRegression()) on (b)'s rows."""
    _sync(device)
    t0 = time.perf_counter()
    model = OneVsRest(classifier=LogisticRegression(device=device)).fit((x[:train], y[:train]))
    _sync(device)
    fit_s = time.perf_counter() - t0
    preds = model._predict_matrix(x[train:])
    coef = np.stack([m.coefficients for m in model.models]).astype(np.float64)
    icpt = np.asarray([m.intercept for m in model.models], dtype=np.float64)
    x64 = x[train:].astype(np.float64)
    z = x64 @ coef.T + icpt
    scores = 1.0 / (1.0 + np.exp(-z))
    ordered = np.sort(scores, axis=1)
    # an f32 margin errs by at most n·u·(|x|·|w| + |b|), a score by a
    # quarter of that, and a gap by twice that
    err = x.shape[1] * UNIT_ROUNDOFF * (np.abs(x64) @ np.abs(coef).T + np.abs(icpt))
    tie = ordered[:, -1] - ordered[:, -2] <= 0.5 * err.max(axis=1)
    want = scores.argmax(1).astype(np.float64)
    out = {"train_rows": train, "classes": model.numClasses, "fit_s": fit_s,
           "held_out_accuracy": float(np.mean(preds == y[train:])),
           "mismatches_beyond_near_ties": int(np.sum((preds != want) & ~tie)),
           "near_ties": int(tie.sum())}
    if out["mismatches_beyond_near_ties"]:
        raise AssertionError(f"one-vs-rest: predictions off the f64 argmax: {out}")
    return out


def phase_families(device: torch.device, higgs: tuple, *, higgs_test_rows: int = HIGGS_TEST_ROWS,
                   mnist_rows: int = MNIST_ROWS, mnist_n: int = MNIST_N,
                   mnist_test_rows: int = MNIST_TEST_ROWS, gbt_stages: int = GBT_STAGES,
                   gbt_depth: int = GBT_DEPTH, gbt_gate_stages: tuple = GBT_GATE_STAGES,
                   mlp_layers: tuple = MLP_LAYERS, mlp_max_iter: int = MLP_MAX_ITER,
                   fm_max_iter: int = FM_MAX_ITER, fm_parity_rows: int = FM_PARITY_ROWS,
                   umap_epochs: int = 0, umap_knn_sample: int = UMAP_KNN_SAMPLE,
                   umap_trust_sample: int = UMAP_TRUST_SAMPLE) -> dict:
    """Phase 17: (a) GBT and (c) FM on phase 16's HIGGS-shaped rows; (b) the
    MLP, (d) UMAP and (e) OneVsRest on MNIST-shaped rows."""
    x, y_cls, y_reg = higgs
    train = len(x) - higgs_test_rows
    out = {}

    def run(name: str, fn, *args, **kwargs):
        # each part prints its numbers (the card's name beside them) before
        # its gates can stop the phase
        out[name] = _timed(f"17 {name}", fn, *args, **kwargs)
        print(f"families {name} ({card_label(device.type)}): {json.dumps(out[name])}",
              flush=True)

    run("(a) gbt", phase_gbt, x, y_cls, y_reg, train, device, stages=gbt_stages,
        depth=gbt_depth, gate_stages=gbt_gate_stages)
    run("(c) fm", phase_fm, x, y_cls, y_reg, train, device, max_iter=fm_max_iter,
        parity_rows=min(fm_parity_rows, train))
    xm, ym = mnist_workload(mnist_rows, mnist_n, MNIST_CLASSES, device)
    mtrain = mnist_rows - mnist_test_rows
    run("(b) mlp", phase_mlp, xm, ym, mtrain, device, layers=mlp_layers, max_iter=mlp_max_iter)
    run("(d) umap", phase_umap, xm, ym, mtrain, device, n_epochs=umap_epochs,
        knn_sample=umap_knn_sample, trust_sample=umap_trust_sample)
    run("(e) one-vs-rest", phase_ovr, xm, ym, mtrain, device)
    R.reset_for_tests()
    return out


# ---------------------------------------------------------------------------
# Phase 18: model selection and recovery
# ---------------------------------------------------------------------------

NEWS_DOCS = 18_846        # 20 Newsgroups: 18,846 documents in 20 classes
NEWS_CLASSES = 20
NEWS_TOKENS = 280         # about 280 tokens a document
NEWS_VOCAB = 50_000       # a Zipf vocabulary of 50,000 terms
NEWS_ZIPF = 1.07
NEWS_CLASS_TERMS = 300    # each class weighs 300 terms of its own 20x
NEWS_CLASS_BOOST = 20.0
NEWS_FEATURES = 1 << 13   # Spark's default is 2^18; the dense layer refuses it (PERF.md §4)
NEWS_SMOOTHING = (0.01, 0.1, 1.0)
TUNING_FOLDS = 3
TUNING_SEED = 59
ADULT_ROWS = 1_000_000    # UCI Adult's 48,842 rows scaled up (PERF.md §4)
# adult.names: the 8 string columns at their published cardinalities, where
# "?" is a category of workclass, occupation and native-country
ADULT_CATEGORIES = {"workclass": 9, "education": 16, "marital-status": 7, "occupation": 15,
                    "relationship": 6, "race": 5, "sex": 2, "native-country": 42}
ADULT_QUESTION = ("workclass", "occupation", "native-country")
ADULT_NUMERIC = ("age", "fnlwgt", "education-num", "capital-gain", "capital-loss",
                 "hours-per-week")
ADULT_POSITIVE_SHARE = 0.24
ADULT_LABELS = ("<=50K", ">50K")
ADULT_LOGREG_GRID = (0.0, 0.01, 0.1)
ADULT_LINREG_GRID = tuple((r, a) for r in (0.001, 0.1) for a in (0.0, 0.5))
ADULT_TRAIN_RATIO = 0.75
TUNING_METRIC_TOL = 1e-4  # AUC absolute, RMSE relative, against the f64 fits
TUNING_GAP = 1e-3         # bestIndex is gated where the f64 best-to-second gap exceeds it
RECOVERY_CHECKPOINT_EVERY = 16
RECOVERY_PREEMPT_AT = 100
RECOVERY_OOM_AT = 50
RECOVERY_IO_AT = (30, 60)  # ingest.chunk, fold.dispatch
RECOVERY_EV_RTOL = 1e-4   # PERF.md §2: the f32 gate of explainedVariance
RESIDENT_RETRY_AT = 3
RESIDENT_HANG_AT, RESIDENT_HANG_S, RESIDENT_HEDGE_FLOOR_S = 5, 2.0, 0.5


class ColumnFrame:
    """A frame of named numpy columns: the column protocol of
    ``utils/columnar.py`` (``columns``, ``assign``, ``frame[name]`` with
    ``to_numpy``/``iloc``/``len``, ``frame.iloc[rows]``), which the card's
    machine, without pandas, needs for the feature stages and model
    selection. A matrix column stays one [rows, n] array."""

    def __init__(self, columns: dict):
        self._cols = dict(columns)

    @property
    def columns(self) -> list:
        return list(self._cols)

    def __len__(self) -> int:
        return len(next(iter(self._cols.values())))

    def __getitem__(self, name: str) -> "_FrameColumn":
        return _FrameColumn(self._cols[name])

    def assign(self, **new) -> "ColumnFrame":
        return ColumnFrame({**self._cols, **{k: _column_array(v) for k, v in new.items()}})

    @property
    def iloc(self) -> "_FrameRows":
        return _FrameRows(self._cols)


class _FrameRows:
    def __init__(self, cols: dict):
        self._cols = cols

    def __getitem__(self, idx) -> ColumnFrame:
        return ColumnFrame({k: v[idx] for k, v in self._cols.items()})


class _FrameColumn:
    def __init__(self, values: np.ndarray):
        self._values = values
        self.iloc = values

    def to_numpy(self) -> np.ndarray:
        return self._values

    def __len__(self) -> int:
        return len(self._values)


def _column_array(values) -> np.ndarray:
    """A column's values as one array: per-row numeric arrays stacked into
    a matrix, other lists (token lists) kept per row."""
    if isinstance(values, list):
        if values and isinstance(values[0], np.ndarray) and values[0].dtype != object:
            try:
                return np.stack(values)
            except ValueError:
                pass
        out = np.empty(len(values), dtype=object)
        for i, v in enumerate(values):
            out[i] = v
        return out
    return np.asarray(values)


def _md5_bucket(term: str, buckets: int) -> int:
    return int.from_bytes(hashlib.md5(term.encode("utf-8")).digest()[:8], "little") % buckets


def news_workload(docs: int, classes: int, tokens: int, vocab: int, seed: int = TUNING_SEED):
    """(documents, labels): 20 Newsgroups' sizes and shape, not its text: a
    seeded Zipf vocabulary (exponent 1.07) of ``vocab`` terms, each class
    weighing 300 terms of its own 20 times more, Poisson(``tokens``)
    tokens a document, a uniform class per document."""
    rng = np.random.default_rng(seed)
    weights = np.tile(1.0 / np.arange(1, vocab + 1) ** NEWS_ZIPF, (classes, 1))
    for c in range(classes):
        boosted = rng.choice(vocab, size=min(NEWS_CLASS_TERMS, vocab), replace=False)
        weights[c, boosted] *= NEWS_CLASS_BOOST
    cdf = np.cumsum(weights, axis=1)
    cdf /= cdf[:, -1:]
    words = np.array([f"w{i}" for i in range(vocab)], dtype=object)
    labels = rng.integers(0, classes, size=docs)
    lengths = np.maximum(rng.poisson(tokens, size=docs), 1)
    texts = np.empty(docs, dtype=object)
    for d in range(docs):
        ids = np.minimum(np.searchsorted(cdf[labels[d]], rng.random(lengths[d])), vocab - 1)
        texts[d] = " ".join(words[ids])
    return texts, labels.astype(np.float64), words


def _nb_f64_model(x: np.ndarray, y: np.ndarray, classes: int, smoothing: float,
                  device: torch.device) -> NaiveBayesModel:
    """The multinomial model of f64 statistics on ``device`` (phase 16's)."""
    c64, s64, _ = _nb_f64_stats(x, y, classes, device)
    pi64 = torch.log(c64 + smoothing) - torch.log(c64.sum() + smoothing * classes)
    theta64 = torch.log(s64 + smoothing) - torch.log(
        s64.sum(1, keepdim=True) + smoothing * x.shape[1])
    model = NaiveBayesModel(pi=pi64.cpu().numpy(), theta=theta64.cpu().numpy(), device=device)
    return model._set(modelType="multinomial")


def _folds(rows: int, folds: int, seed: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """(train, validation) rows of each fold, as CrossValidator draws them."""
    parts = np.array_split(np.random.default_rng(seed).permutation(rows), folds)
    return [(np.concatenate([parts[i] for i in range(folds) if i != f]), parts[f])
            for f in range(folds)]


def _best_gap(metrics, larger_better: bool) -> float:
    s = sorted(metrics, reverse=larger_better)
    return abs(s[0] - s[1]) if len(s) > 1 else float("inf")


def phase_text_selection(device: torch.device, *, docs: int = NEWS_DOCS,
                         classes: int = NEWS_CLASSES, tokens: int = NEWS_TOKENS,
                         vocab: int = NEWS_VOCAB, features: int = NEWS_FEATURES,
                         folds: int = TUNING_FOLDS, seed: int = TUNING_SEED) -> dict:
    """(a) Tokenizer → HashingTF → IDF on a 20 Newsgroups-shaped corpus, then
    CrossValidator over multinomial NaiveBayes's smoothing. Gates: the TF
    matrix is an independent hashlib + Counter construction; IDF is numpy's
    f64 formula; every candidate's fold predictions are the f64 fit's but
    for near ties (phase 16's rule), so avgMetrics agree within the near-tie
    share; bestIndex is the f64 run's."""
    t0 = time.perf_counter()
    texts, labels, words = news_workload(docs, classes, tokens, vocab, seed)
    frame = ColumnFrame({"text": texts, "label": labels})
    make_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tokenized = Tokenizer().setInputCol("text").setOutputCol("words").transform(frame)
    tf_frame = HashingTF(numFeatures=features).setInputCol("words").setOutputCol(
        "tf").transform(tokenized)
    tf_s = time.perf_counter() - t0
    tf = columnar.extract_matrix(tf_frame, "tf")
    t0 = time.perf_counter()
    bucket_of = {w: _md5_bucket(w, features) for w in words}
    expected = np.zeros((docs, features))
    for i, text in enumerate(texts):
        for term, count in collections.Counter(text.lower().split()).items():
            expected[i, bucket_of[term]] += count
    reference_s = time.perf_counter() - t0
    tf_mismatches = int((tf != expected).sum())
    del expected
    t0 = time.perf_counter()
    idf_model = IDF().setInputCol("tf").setOutputCol("features").fit(tf_frame)
    x = columnar.extract_matrix(idf_model.transform(tf_frame), "features")
    idf_s = time.perf_counter() - t0
    df = (tf > 0).sum(axis=0).astype(np.float64)
    idf_equal = bool(np.array_equal(idf_model.idf, np.log((docs + 1.0) / (df + 1.0))))
    del tf, tf_frame, tokenized

    grid = ParamGridBuilder().addGrid("smoothing", list(NEWS_SMOOTHING)).build()
    data = ColumnFrame({"features": x, "label": labels})
    _sync(device)
    reset_launches()
    t0 = time.perf_counter()
    cvm = CrossValidator(
        estimator=NaiveBayes(device=device, modelType="multinomial"),
        estimatorParamMaps=grid,
        evaluator=MulticlassClassificationEvaluator(metricName="accuracy"),
        numFolds=folds, seed=seed, collectSubModels=True,
    ).fit(data)
    _sync(device)
    cv_s = time.perf_counter() - t0
    launches = read_launches()
    acc64 = np.zeros((len(grid), folds))
    near_share = np.zeros((len(grid), folds))
    beyond = mismatches = 0
    for f, (train, val) in enumerate(_folds(docs, folds, seed)):
        for c, params in enumerate(grid):
            ref = _nb_f64_model(x[train], labels[train], classes, params["smoothing"], device)
            raw64 = ref._raw_scores(x[val])
            raw = cvm.subModels[f][c]._raw_scores(x[val])
            top2 = np.sort(raw64, axis=1)[:, -2:]
            near = (top2[:, 1] - top2[:, 0]) <= 2.0 * np.abs(raw - raw64).max(axis=1)
            off = np.argmax(raw, axis=1) != np.argmax(raw64, axis=1)
            mismatches += int(off.sum())
            beyond += int((off & ~near).sum())
            near_share[c, f] = near.mean()
            acc64[c, f] = float(np.mean(np.argmax(raw64, axis=1) == labels[val]))
    avg64 = acc64.mean(axis=1)
    metric_gap = np.abs(np.asarray(cvm.avgMetrics) - avg64)
    result = {
        "docs": docs, "classes": classes, "vocab": vocab, "num_features": features,
        "tokens": int(sum(len(t.split()) for t in texts)), "make_s": make_s,
        "tokenize_hash_s": tf_s, "reference_tf_s": reference_s, "idf_s": idf_s, "cv_s": cv_s,
        "tf_mismatches_vs_hashlib_counter": tf_mismatches, "idf_equals_numpy_f64": idf_equal,
        "avg_metrics": list(cvm.avgMetrics), "avg_metrics_f64": avg64.tolist(),
        "near_tie_share": near_share.mean(axis=1).tolist(),
        "prediction_mismatches": mismatches, "mismatches_beyond_near_ties": beyond,
        "best_index": cvm.bestIndex, "best_index_f64": int(np.argmax(avg64)),
        "launches": launches,
    }
    print(f"selection (a) text: {json.dumps(result)}", flush=True)
    if tf_mismatches:
        raise AssertionError(f"HashingTF differs from hashlib + Counter in {tf_mismatches} cells")
    if not idf_equal:
        raise AssertionError("IDF is not numpy's f64 log((m + 1) / (df + 1))")
    if beyond:
        raise AssertionError(f"{beyond} fold predictions off the f64 fits' beyond near ties")
    if not np.all(metric_gap <= near_share.mean(axis=1) + 1e-12):
        raise AssertionError(f"avgMetrics {cvm.avgMetrics} off f64 {avg64} beyond near ties")
    if cvm.bestIndex != result["best_index_f64"]:
        raise AssertionError(f"bestIndex {cvm.bestIndex}, the f64 run's {result['best_index_f64']}")
    if launches != expected_launches():
        raise AssertionError(f"the text search launched Gram kernels: {launches}")
    return result


def adult_workload(rows: int, seed: int = TUNING_SEED) -> ColumnFrame:
    """UCI Adult's schema (adult.names) at ``rows`` seeded rows: 6 integer
    numeric columns at Adult's scales, 8 string columns at their published
    cardinalities (Dirichlet-skewed frequencies, each at least half its
    uniform share), the income label with
    about 24% ">50K" from a seeded linear score plus logistic noise, and
    hours-per-week depending on the other columns."""
    rng = np.random.default_rng(seed)
    cols: dict = {}
    effects = np.zeros(rows)
    hours_effect = np.zeros(rows)
    for name, k in ADULT_CATEGORIES.items():
        names = [f"{name}-{i}" for i in range(k - (name in ADULT_QUESTION))]
        names += ["?"] if name in ADULT_QUESTION else []
        # skewed, with every category at least half its uniform share
        codes = rng.choice(k, size=rows, p=0.5 * rng.dirichlet(np.full(k, 0.7)) + 0.5 / k)
        cols[name] = np.array(names, dtype=object)[codes]
        effects += rng.normal(0.0, 0.6, size=k)[codes]
        hours_effect += rng.normal(0.0, 2.0, size=k)[codes]
    age = np.clip(np.round(rng.normal(38.6, 13.6, rows)), 17, 90)
    edu = rng.integers(1, 17, size=rows).astype(np.float64)
    gain = np.where(rng.random(rows) < 0.083, np.round(np.exp(rng.normal(8.5, 1.0, rows))), 0.0)
    loss = np.where(rng.random(rows) < 0.047, np.round(rng.normal(1870.0, 360.0, rows)), 0.0)
    numeric = {
        "age": age,
        "fnlwgt": np.round(np.exp(rng.normal(12.0, 0.5, rows))),
        "education-num": edu,
        "capital-gain": np.minimum(gain, 99999.0),
        "capital-loss": np.maximum(loss, 0.0),
        "hours-per-week": np.clip(np.round(40.0 + 0.08 * (age - 38.6) + hours_effect
                                           + rng.normal(0.0, 10.0, rows)), 1, 99),
    }
    score = (effects + 0.04 * (age - 38.6) + 0.3 * (edu - 10.0) + 2e-4 * numeric["capital-gain"]
             + 0.02 * (numeric["hours-per-week"] - 40.0) + rng.logistic(size=rows))
    positive = score > np.quantile(score, 1.0 - ADULT_POSITIVE_SHARE)
    cols.update(numeric)
    cols["income"] = np.array(ADULT_LABELS, dtype=object)[positive.astype(int)]
    return ColumnFrame(cols)


def _one_hot_numpy(values: np.ndarray) -> np.ndarray:
    """StringIndexer's frequencyDesc order (ties alphabetical) and
    OneHotEncoder's dropLast one-hot, built straight in numpy."""
    uniq, inverse, counts = np.unique(values.astype(str), return_inverse=True,
                                      return_counts=True)
    order = np.lexsort((uniq, -counts))
    rank = np.empty(len(uniq), dtype=np.int64)
    rank[order] = np.arange(len(uniq))
    return np.eye(len(uniq))[rank[inverse]][:, :-1]


def _auc(y: np.ndarray, scores: np.ndarray) -> float:
    return BinaryClassificationEvaluator().evaluate((None, y), predictions=scores)


def phase_adult_selection(device: torch.device, *, rows: int = ADULT_ROWS,
                          folds: int = TUNING_FOLDS, seed: int = TUNING_SEED) -> dict:
    """(b) Adult's raw columns through a Pipeline of 8 StringIndexers, 8
    OneHotEncoders (dropLast), a VectorAssembler (100 columns) and a
    StandardScaler (withMean, withStd: what Spark's LogisticRegression does
    inside by default; on Adult's raw scales neither package's f32 Newton
    converges, PERF.md §6), then
    CrossValidator(LogisticRegression, areaUnderROC) and
    TrainValidationSplit(LinearRegression, rmse) predicting hours-per-week
    from the rest (the FISTA path where elasticNetParam > 0), both on the
    card, and IndexToString back to the income labels. Gates: the one-hot
    matrix is numpy's; each candidate's AUC (absolute) and RMSE (relative)
    within 1e-4 of f64 fits of the same folds; bestIndex the f64 run's
    wherever the f64 best-to-second gap exceeds 1e-3."""
    t0 = time.perf_counter()
    frame = adult_workload(rows, seed)
    make_s = time.perf_counter() - t0
    cats = list(ADULT_CATEGORIES)
    stages = ([StringIndexer().setInputCol(c).setOutputCol(f"{c}_idx") for c in cats]
              + [OneHotEncoder().setInputCol(f"{c}_idx").setOutputCol(f"{c}_vec") for c in cats]
              + [VectorAssembler().setInputCols(list(ADULT_NUMERIC) + [f"{c}_vec" for c in cats])
                 .setOutputCol("assembled"),
                 StandardScaler(device=device, withMean=True, withStd=True)
                 .setInputCol("assembled").setOutputCol("features")])
    t0 = time.perf_counter()
    features = Pipeline(stages=stages).fit(frame).transform(frame)
    label_indexer = StringIndexer().setInputCol("income").setOutputCol("label").fit(frame)
    labelled = label_indexer.transform(features)
    features_s = time.perf_counter() - t0
    assembled = columnar.extract_matrix(labelled, "assembled")
    x = columnar.extract_matrix(labelled, "features")
    y = columnar.extract_vector(labelled, "label")
    expected = np.concatenate([np.stack([frame[c].to_numpy() for c in ADULT_NUMERIC], 1)]
                              + [_one_hot_numpy(frame[c].to_numpy()) for c in cats], axis=1)
    one_hot_mismatches = (int((assembled != expected).sum())
                          if assembled.shape == expected.shape else -1)
    del expected, features

    # CrossValidator over LogisticRegression's regParam, ranked by AUC
    grid = [{"regParam": r} for r in ADULT_LOGREG_GRID]
    _sync(device)
    reset_launches()
    t0 = time.perf_counter()
    cvm = CrossValidator(estimator=LogisticRegression(device=device), estimatorParamMaps=grid,
                         evaluator=BinaryClassificationEvaluator(), numFolds=folds, seed=seed,
                         collectSubModels=True).fit(ColumnFrame({"features": x, "label": y}))
    _sync(device)
    cv_s = time.perf_counter() - t0
    cv_launches = read_launches()
    auc = np.zeros((len(grid), folds))
    auc64 = np.zeros((len(grid), folds))
    for f, (train, val) in enumerate(_folds(rows, folds, seed)):
        xd = to_device(x[train], device)
        yd = torch.from_numpy(y[train]).to(device).double()
        xv = torch.from_numpy(x[val]).to(device).double()
        for c, params in enumerate(grid):
            w64, _, _ = newton_oracle_f64(xd, yd, params["regParam"])
            p64 = torch.sigmoid(xv @ w64[:-1] + w64[-1]).cpu().numpy()
            auc64[c, f] = _auc(y[val], p64)
            auc[c, f] = _auc(y[val], cvm.subModels[f][c].predict_proba_matrix(x[val]))
        del xd, yd, xv
    avg64 = auc64.mean(axis=1)
    auc_err = float(max(np.abs(auc - auc64).max(), np.abs(np.asarray(cvm.avgMetrics) - avg64).max()))
    cv_gap = _best_gap(avg64, True)

    # TrainValidationSplit over LinearRegression, hours-per-week from the rest
    hours_col = ADULT_NUMERIC.index("hours-per-week")
    xh = np.delete(x, hours_col, axis=1)
    hours = assembled[:, hours_col].astype(np.float64)
    tvs_grid = [{"regParam": r, "elasticNetParam": a} for r, a in ADULT_LINREG_GRID]
    est = LinearRegression(device=device)
    _sync(device)
    reset_launches()
    t0 = time.perf_counter()
    tvsm = TrainValidationSplit(estimator=est, estimatorParamMaps=tvs_grid,
                                evaluator=RegressionEvaluator(), trainRatio=ADULT_TRAIN_RATIO,
                                seed=seed).fit(ColumnFrame({"features": xh, "label": hours}))
    _sync(device)
    tvs_s = time.perf_counter() - t0
    tvs_launches = read_launches()
    idx = np.random.default_rng(seed).permutation(rows)
    cut = int(rows * ADULT_TRAIN_RATIO)
    stats64, _ = linear_stats_f64(xh[idx[:cut]], hours[idx[:cut]], None, device)
    xv = torch.from_numpy(xh[idx[cut:]]).to(device).double()
    rmse64 = []
    for params in tvs_grid:
        coef, b0 = LIN.solve_from_stats(
            stats64, reg_param=params["regParam"], elastic_net_param=params["elasticNetParam"],
            max_iter=est.getOrDefault("maxIter"), tol=est.getOrDefault("tol"))
        pred = (xv @ coef + b0).cpu().numpy()
        rmse64.append(float(np.sqrt(np.mean((pred - hours[idx[cut:]]) ** 2))))
    del xv
    rmse_err = float(np.max(np.abs(np.asarray(tvsm.validationMetrics) / rmse64 - 1.0)))
    tvs_gap = _best_gap(rmse64, False)

    # the best model's predictions back to the income labels
    preds = cvm.bestModel.transform(ColumnFrame({"features": x, "label": y}))
    names = IndexToString().setInputCol("prediction").setOutputCol("predicted_income").setLabels(
        label_indexer.labels).transform(preds)["predicted_income"].to_numpy()
    pred_idx = preds["prediction"].to_numpy().astype(int)
    labels_ok = bool(np.array_equal(names, np.asarray(label_indexer.labels, dtype=object)[pred_idx]))
    result = {
        "rows": rows, "columns": int(x.shape[1]), "make_s": make_s, "features_s": features_s,
        "positive_share": float(y.mean()), "label_order": list(label_indexer.labels),
        "one_hot_mismatches_vs_numpy": one_hot_mismatches,
        "cv": {"avg_auc": list(cvm.avgMetrics), "avg_auc_f64": avg64.tolist(),
               "max_auc_err_vs_f64": auc_err, "best_index": cvm.bestIndex,
               "best_index_f64": int(np.argmax(avg64)), "f64_best_gap": cv_gap,
               "s": cv_s, "launches": cv_launches},
        "tvs": {"rmse": list(tvsm.validationMetrics), "rmse_f64": rmse64,
                "max_rmse_rel_err_vs_f64": rmse_err, "best_index": tvsm.bestIndex,
                "best_index_f64": int(np.argmin(rmse64)), "f64_best_gap": tvs_gap,
                "s": tvs_s, "launches": tvs_launches},
        "index_to_string_equal": labels_ok,
        "held_out_style_accuracy": float(np.mean(pred_idx == y)),
    }
    print(f"selection (b) tabular: {json.dumps(result)}", flush=True)
    if x.shape[1] != 100 or one_hot_mismatches:
        raise AssertionError(f"features {x.shape} differ from numpy's one-hot ({one_hot_mismatches})")
    if not auc_err <= TUNING_METRIC_TOL:
        raise AssertionError(f"AUC {auc_err} off the f64 fits")
    if not rmse_err <= TUNING_METRIC_TOL:
        raise AssertionError(f"RMSE {rmse_err} off the f64 fits (relative)")
    if cv_gap > TUNING_GAP and cvm.bestIndex != int(np.argmax(avg64)):
        raise AssertionError(f"CV bestIndex {cvm.bestIndex}, the f64 run's {np.argmax(avg64)}")
    if tvs_gap > TUNING_GAP and tvsm.bestIndex != int(np.argmin(rmse64)):
        raise AssertionError(f"TVS bestIndex {tvsm.bestIndex}, the f64 run's {np.argmin(rmse64)}")
    if not labels_ok:
        raise AssertionError("IndexToString did not map the predictions to their labels")
    return result


def _fault_run(plan: str | None, fn, **env):
    """``fn()`` under a fault plan (and ``env``), from fresh site counts:
    (result or the exception it raised, registry delta, kernel launches,
    seconds)."""
    faults.reset_faults()
    s0 = REGISTRY.snapshot()
    reset_launches()
    t0 = time.perf_counter()
    with _env(TPU_ML_FAULT_PLAN=plan, **env):
        try:
            out = fn()
        except (faults.FaultInjected, FoldHangTimeout) as e:
            out = e
    seconds = time.perf_counter() - t0
    faults.reset_faults()
    return out, REGISTRY.snapshot().delta(s0), read_launches(), seconds


def _carry_equal(a, b) -> bool:
    return all(torch.equal(p, q) for p, q in zip(a, b))


def phase_recovery_streamed(data, device: torch.device, *, k: int = MAIN_K,
                            chunk_rows: int | None = None,
                            checkpoint_every: int = RECOVERY_CHECKPOINT_EVERY,
                            preempt_at: int = RECOVERY_PREEMPT_AT, oom_at: int = RECOVERY_OOM_AT,
                            io_at: tuple = RECOVERY_IO_AT) -> dict:
    """(c) Config 2's streamed fold at "high" through symmetric_gram_moments
    under fault plans, each run against one clean run of this phase:
    (i) a preemption, then a resume from the checkpoints; (ii) transient
    faults at ingest.chunk and fold.dispatch; (iii) an OOM that bisects;
    (iv) a short hang of fold.wait inside its bound; (v) a long one past it,
    which must raise FoldHangTimeout. ``data`` is phase 8's (x, f64 Gram);
    its chunk-sized views are the re-iterable source."""
    x, gram64 = data
    n = x.shape[1]
    chunk = chunk_rows or ingest.stream_chunk_rows()
    chunks = -(-len(x) // chunk)
    # the source: one item a chunk (views of x), so that the ingest.chunk
    # site counts as many occurrences as the fold has chunks
    parts = [x[a:a + chunk] for a in range(0, len(x), chunk)]
    cuda = device.type == "cuda"

    def fold(**kw):
        res = ingest.stream_fold(iter(parts), L.gram_fold_step("high"), n=n,
                                 init=L.init_gram_carry(n, device), device=device,
                                 chunk_rows=chunk, **kw)
        _sync(device)
        return res

    def pca(res):
        cov = L.covariance_from_stats(res.carry, mean_centering=False)
        pc, ev = L.pca_fit_from_cov(cov, k, solver="full")
        return pc.cpu().numpy(), ev.cpu().numpy()

    def launched(count: int) -> dict:
        return expected_launches(symmetric_gram_moments=count if cuda else 0)

    runs, failures = {}, []

    def check(cond: bool, what: str) -> None:
        if not cond:
            failures.append(what)

    clean, _, launches, secs = _fault_run(None, fold)
    clean_pc, clean_ev = pca(clean)
    runs["clean"] = {"s": secs, "chunks": clean.chunks, "launches": launches}
    check(launches == launched(chunks) and clean.chunks == chunks, "clean launches")

    with tempfile.TemporaryDirectory(prefix="stream-ckpt-") as ckdir:
        ckpt = TrainingCheckpointer(ckdir)
        kw = {"checkpointer": ckpt, "checkpoint_every": checkpoint_every}
        err, d1, l1, s1 = _fault_run(f"fold.dispatch:preempt:{preempt_at}", lambda: fold(**kw))
        res, d2, l2, s2 = _fault_run(None, lambda: fold(**kw))
    pc, ev = pca(res)
    runs["(i) preempt, resume"] = {
        "preempted": type(err).__name__, "checkpoints": d1.counter("stream.checkpoints"),
        "resumes": d2.counter("stream.resumes"), "resumed": res.resumed,
        "launches": [l1, l2], "s": [s1, s2],
        "carry_bit_equal": _carry_equal(res.carry, clean.carry),
        "pc_bit_equal": bool(np.array_equal(pc, clean_pc)),
    }
    saved = (preempt_at - 1) // checkpoint_every
    check(isinstance(err, faults.InjectedPreemption), "(i) preemption raised")
    check(d1.counter("stream.checkpoints") == saved and d2.counter("stream.resumes") == 1
          and res.resumed, "(i) checkpoints and resume")
    check(l1 == launched(preempt_at - 1) and l2 == launched(chunks - saved * checkpoint_every),
          "(i) launches")
    check(runs["(i) preempt, resume"]["carry_bit_equal"]
          and runs["(i) preempt, resume"]["pc_bit_equal"], "(i) bit-equal")

    res, d, lc, s = _fault_run(f"ingest.chunk:io:{io_at[0]},fold.dispatch:io:{io_at[1]}", fold)
    retries = {site: d.counter("retry.attempts", site=site)
               for site in ("ingest.chunk", "fold.dispatch")}
    runs["(ii) transient"] = {"retries": retries, "launches": lc, "s": s,
                              "carry_bit_equal": _carry_equal(res.carry, clean.carry),
                              "pc_bit_equal": bool(np.array_equal(pca(res)[0], clean_pc))}
    check(retries == {"ingest.chunk": 1, "fold.dispatch": 1}, "(ii) one retry a site")
    check(lc == launched(chunks) and runs["(ii) transient"]["carry_bit_equal"]
          and runs["(ii) transient"]["pc_bit_equal"], "(ii) bit-equal")

    res, d, lc, s = _fault_run(f"fold.dispatch:oom:{oom_at}", fold)
    floor = int(os.environ.get(ingest.STREAM_CHUNK_FLOOR_VAR, ingest.DEFAULT_STREAM_CHUNK_FLOOR))
    half = chunk // 2 - (chunk // 2) % floor
    bisected = (oom_at - 1) + -(-(len(x) - (oom_at - 1) * chunk) // half)
    pc, ev = pca(res)
    oracle_pc, _ = oracle_from_scatter(gram64, k)
    runs["(iii) oom"] = {
        "bisections": res.bisections, "chunks": res.chunks, "expected_chunks": bisected,
        "half_rows": half, "launches": lc, "extra_launches": bisected - chunks, "s": s,
        "min_cosine_vs_f64_oracle": _min_abs_cosine(pc, oracle_pc),
        "ev_max_rel_diff_vs_clean": float(np.abs(ev / clean_ev - 1.0).max()),
    }
    check(res.bisections >= 1 and d.counter("chunk.bisections") == res.bisections,
          "(iii) bisections")
    check(res.chunks == bisected and lc == launched(bisected), "(iii) later chunks at half size")
    check(runs["(iii) oom"]["min_cosine_vs_f64_oracle"] >= COSINE_BAR, "(iii) f64 oracle")
    check(runs["(iii) oom"]["ev_max_rel_diff_vs_clean"] <= RECOVERY_EV_RTOL, "(iii) ev")

    res, _, lc, s = _fault_run("fold.wait:hang:1:0.2", lambda: fold(fold_wait_timeout_s=30.0))
    runs["(iv) hang inside the bound"] = {"s": s, "launches": lc,
                                          "carry_bit_equal": _carry_equal(res.carry, clean.carry)}
    check(runs["(iv) hang inside the bound"]["carry_bit_equal"], "(iv) bit-equal")

    err, _, lc, s = _fault_run("fold.wait:hang:1:3.0", lambda: fold(fold_wait_timeout_s=0.5))
    _sync(device)
    runs["(v) hang past the bound"] = {"raised": type(err).__name__, "s": s, "launches": lc}
    check(isinstance(err, FoldHangTimeout), "(v) FoldHangTimeout")

    result = {"rows": len(x), "n": n, "chunk_rows": chunk, "chunks": chunks, "runs": runs,
              "failures": failures}
    print(f"recovery (c) streamed: {json.dumps(result, default=str)}", flush=True)
    if failures:
        raise AssertionError(f"streamed recovery gates failed: {failures}")
    return result


def phase_recovery_resident(rows: int, n: int, k: int, partitions: int,
                            device: torch.device) -> dict:
    """(d) The resident fit (fused_gram_moments once a partition) with a
    task that fails once (retried: the fault fires before the task's body,
    so the launches stay one a partition) and a task that hangs (hedged:
    both attempts run the body, one launch more). pc is bit-equal to the
    clean fit's in both."""
    x = bench_workload(rows, n)
    cuda = device.type == "cuda"

    def fit():
        model = PCA(device=device).setK(k).setPrecision("high").fit(x, num_partitions=partitions)
        _sync(device)
        return model

    def launched(count: int) -> dict:
        return expected_launches(gram_moments=count if cuda else 0)

    clean, _, lc0, s0 = _fault_run(None, fit)
    retried, dr, lr, sr = _fault_run(f"worker.task:io:{RESIDENT_RETRY_AT}", fit)
    hedged, dh, lh, sh = _fault_run(f"worker.task:hang:{RESIDENT_HANG_AT}:{RESIDENT_HANG_S}", fit,
                                    TPU_ML_HEDGE_FLOOR_S=str(RESIDENT_HEDGE_FLOOR_S))
    result = {
        "rows": rows, "n": n, "partitions": partitions,
        "clean": {"s": s0, "launches": lc0},
        "retry": {"s": sr, "launches": lr, "retries": dr.counter("retry.attempts", site="worker.task"),
                  "pc_bit_equal": bool(np.array_equal(retried.pc, clean.pc))},
        "hedge": {"s": sh, "launches": lh, "hedges": dh.counter("scheduler.hedge"),
                  "pc_bit_equal": bool(np.array_equal(hedged.pc, clean.pc)),
                  "ev_bit_equal": bool(np.array_equal(hedged.explainedVariance,
                                                      clean.explainedVariance))},
    }
    print(f"recovery (d) resident: {json.dumps(result)}", flush=True)
    if lc0 != launched(partitions) or lr != launched(partitions):
        raise AssertionError(f"a retried fit launched {lr} (clean {lc0}), not one a partition")
    if result["retry"]["retries"] != 1 or not result["retry"]["pc_bit_equal"]:
        raise AssertionError(f"the retried fit is not the clean one: {result['retry']}")
    if result["hedge"]["hedges"] != 1 or lh != launched(partitions + 1):
        raise AssertionError(f"the straggler was not hedged once: {result['hedge']}")
    if not result["hedge"]["pc_bit_equal"]:
        raise AssertionError("the hedged fit is not the clean one")
    return result


def phase_device_policy(device: torch.device) -> dict:
    """(e) The device policy on the card: the bounded first-touch probe, the
    health monitor's subprocess probe, and a device.init fault failing the
    inline probe, which the transport component reads."""
    platform = "cuda" if device.type == "cuda" else "cpu"
    t0 = time.perf_counter()
    probed = devicepolicy.probe_platform(expected=platform, timeout=60.0)
    probe_s = time.perf_counter() - t0
    used = devicepolicy.use_platform(platform, probe_timeout=60.0)

    def monitor(mode: str):
        mon = health.HealthMonitor(probe_mode=mode, probe_timeout_s=120.0, interval_s=60.0,
                                   failing_after=3, slo_engine=slo.SloEngine(()))
        mon.poll_once()
        return mon.rollup()["components"]

    t0 = time.perf_counter()
    sub = monitor("subprocess")
    subprocess_s = time.perf_counter() - t0
    comps, d, _, _ = _fault_run("device.init:io:1", lambda: monitor("inline"))
    result = {
        "probe_platform": probed, "probe_s": probe_s, "use_platform": str(used),
        "subprocess_probe": sub["transport"], "subprocess_probe_s": subprocess_s,
        "faulted_inline_probe": comps["transport"],
        "injected": d.counter("fault.injected", site="device.init", kind="io"),
    }
    print(f"device policy (e): {json.dumps(result)}", flush=True)
    if probed != platform or used.type != platform:
        raise AssertionError(f"the probe found {probed!r}, not {platform!r}")
    if sub["transport"]["state"] != "OK" or sub["transport"]["detail"] != platform:
        raise AssertionError(f"the subprocess probe read {sub['transport']}")
    if (comps["transport"]["state"] != "DEGRADED" or result["injected"] != 1
            or "InjectedTransientIOError" not in comps["transport"]["detail"]):
        raise AssertionError(f"the device.init fault did not fail the probe: {comps['transport']}")
    return result


# -- phase 19: cost model, autotune, partition bodies -------------------------

# the card's peak the cost model's roofline divides by (telemetry/costmodel.py)
COST_ROOFLINE_MAX = 1.05
# each search trial folds one warm-up and ``reps`` (1) timed chunks
TRIAL_FOLDS = 2
# phase 19 (c): each partition reaches the partition body as this many batches
PARTITION_BATCHES = 2


def gram_cost_at(rows: int, n: int) -> float:
    """``linalg.gram_stats``'s analytical flops at a [rows, n] padded block."""
    return 2.0 * rows * n * n + 2.0 * rows * n


def phase_cost_model(rows: int, n: int, k: int, partitions: int, device: torch.device) -> dict:
    """Phase 19 (a): the resident "high" fit and a transform of phase 4's
    rows, read through the cost model: the fit's ``linalg.gram_stats`` calls
    equal its partitions and its ``fused_gram_moments`` launches, each
    call's flops are the formula at the padded partition, the roofline share
    lies in (0, 1.05], and the transform books ``linalg.project``."""
    x = bench_workload(rows, n)
    cuda = device.type == "cuda"
    pca = PCA(device=device).setInputCol("features").setK(k).setPrecision("high")
    reset_launches()
    model = pca.fit(x, num_partitions=partitions)
    launches = read_launches()
    cost = model.fit_report.cost_model
    gram = cost["kernels"]["linalg.gram_stats"]
    padded = columnar.bucket_rows(-(-rows // partitions))
    out = model.transform(x)
    project = model.transform_report.cost_model["kernels"]["linalg.project"]
    result = {
        "rows": rows, "n": n, "partitions": partitions, "padded_rows": padded,
        "launches": launches, "gram_stats": gram, "project": project,
        "roofline_utilization": cost.get("roofline_utilization"),
        "fit_s": model.fit_report.wall_seconds,
        "transform_s": model.transform_report.wall_seconds,
        "transform_roofline_utilization":
            model.transform_report.cost_model.get("roofline_utilization"),
    }
    print(f"cost model (a): {json.dumps(result)}", flush=True)
    if gram["calls"] != partitions:
        raise AssertionError(f"linalg.gram_stats booked {gram['calls']} calls, not {partitions}")
    expected = expected_launches(gram_moments=partitions if cuda else 0)
    if launches != expected:
        raise AssertionError(f"kernel launches in the fit {launches}, expected {expected}")
    if gram["flops"] != gram_cost_at(padded, n):
        raise AssertionError(f"per-call flops {gram['flops']} != {gram_cost_at(padded, n)}")
    util = result["roofline_utilization"]
    if not (util is not None and 0.0 < util <= COST_ROOFLINE_MAX):
        raise AssertionError(f"roofline utilization {util} outside (0, {COST_ROOFLINE_MAX}]")
    if project["calls"] != 1 or out.shape != (rows, k):
        raise AssertionError(f"the transform booked {project} and gave {out.shape}")
    result["model"], result["out"] = model, out
    return result


def phase_partition_bodies(rows: int, n: int, k: int, partitions: int, device: torch.device,
                           model, out: np.ndarray) -> dict:
    """Phase 19 (c): the Spark glue's partition bodies on the card, without
    pyarrow: ``FitPartitionFn.partition_stats`` over phase 4's partitions,
    each as ``PARTITION_BATCHES`` frames of named columns, one
    ``fused_gram_moments`` launch a batch; the stats merged in f64 on the
    host as the driver merges them, decomposed on the card, and held to the
    f64 oracle; then ``TransformPartitionFn``'s array body over every row,
    held to phase (a)'s transform of the same model."""
    x = bench_workload(rows, n)
    cuda = device.type == "cuda"
    fit_fn = arrow_fns.FitPartitionFn("features", precision="high", device=device.type)
    reset_launches()
    t0 = time.perf_counter()
    merged = None
    for part in np.array_split(x, partitions):
        batches = [ColumnFrame({"features": b}) for b in np.array_split(part, PARTITION_BATCHES)]
        stats = fit_fn.partition_stats(batches)
        host = [t.double().cpu().numpy() for t in stats]
        merged = host if merged is None else [a + b for a, b in zip(merged, host)]
    stats_s = time.perf_counter() - t0
    launches = read_launches()
    gram = L.GramStats(*(torch.as_tensor(a, dtype=torch.float32, device=device) for a in merged))
    pc, _ = L.pca_fit_from_cov(L.covariance_from_stats(gram, mean_centering=False), k)
    min_cos = L.min_cosine_vs_f64_oracle(x, pc, k)
    transform_fn = arrow_fns.TransformPartitionFn("features", "pca", model.pc,
                                                  device=device.type)
    t0 = time.perf_counter()
    body = transform_fn.project_matrix(x)
    transform_s = time.perf_counter() - t0
    err = float(np.abs(body - out).max())
    tol = SERVE_REL_TOL * float(np.abs(out).max())
    result = {
        "launches": launches, "count": float(merged[2]), "min_cosine_vs_f64_oracle": min_cos,
        "partition_stats_s": stats_s, "transform_body_s": transform_s,
        "transform_max_abs_err": err, "transform_tol": tol,
    }
    print(f"partition bodies (c): {json.dumps(result)}", flush=True)
    expected = expected_launches(
        gram_moments=partitions * PARTITION_BATCHES if cuda else 0)
    if launches != expected:
        raise AssertionError(f"partition-body launches {launches}, expected {expected}")
    if merged[2] != rows:
        raise AssertionError(f"the merged count is {merged[2]}, not {rows}")
    if not min_cos >= COSINE_BAR:
        raise AssertionError(f"partition-body fit min cosine vs f64 {min_cos} < {COSINE_BAR}")
    if body.shape != out.shape or not err <= tol:
        raise AssertionError(f"the transform body is off by {err} > {tol}")
    return result


def _fit_tuned(x: np.ndarray, k: int, partitions: int, device: torch.device) -> dict:
    """One streamed "high" fit and what the tuner and the kernels did in it."""
    s0 = REGISTRY.snapshot()
    reset_launches()
    t0 = time.perf_counter()
    model = PCA(device=device).setK(k).setPrecision("high").fit(x, num_partitions=partitions)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    fit_s = time.perf_counter() - t0
    delta = REGISTRY.snapshot().delta(s0)
    return {
        "model": model, "fit_s": fit_s, "launches": read_launches(),
        "tuning": model.fit_report.tuning,
        "fold_calls": model.fit_report.cost_model["kernels"]["stream.fold_step"]["calls"],
        "trials": int(delta.counter("autotune.trials")),
        "chunks": model.stream_report.chunks,
    }


def phase_autotune(data, k: int, partitions: int, device: torch.device) -> dict:
    """Phase 19 (b): BASELINE config 2 fitted under TPU_ML_AUTOTUNE=search
    with a tuning-cache file in a fresh temporary directory, then again under
    ``cache``. The search's trials fold synthetic chunks into throwaway
    carries through ``symmetric_gram_moments`` (``TRIAL_FOLDS`` launches a
    trial), the fit folds ⌈rows / winner⌉ chunks, and the cached fit is bit
    for bit the searched one. Each candidate's seconds per row are measured
    again beside them. The in-process cache is emptied afterwards, so later
    fits keep the static knobs."""
    x, gram64 = data
    rows, n = x.shape
    cuda = device.type == "cuda"
    kernel = "symmetric_gram_moments" if cuda else None
    oracle_pc, _ = oracle_from_scatter(gram64, k)
    base = ingest.stream_chunk_rows()
    candidates = autotune.candidate_grid(base)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-tuning-")
    try:
        tuning_cache.reset()
        with _env(TPU_ML_AUTOTUNE="search",
                  TPU_ML_TUNING_CACHE_PATH=os.path.join(tmp, "tuning.json")):
            searched = _fit_tuned(x, k, partitions, device)
            budget = autotune.trial_budget()
        with _env(TPU_ML_AUTOTUNE="cache",
                  TPU_ML_TUNING_CACHE_PATH=os.path.join(tmp, "tuning.json")):
            cached = _fit_tuned(x, k, partitions, device)
        measure = autotune.stream_fold_measure(
            L.gram_fold_step("high"), L.init_gram_carry(n, device), n, device)
        seconds_per_row = {c.chunk_rows: measure(c) for c in candidates}
    finally:
        tuning_cache.reset()
        shutil.rmtree(tmp, ignore_errors=True)
    winner = searched["tuning"]["config"]["chunk_rows"]
    fold_chunks = -(-rows // winner)
    min_cos = _min_abs_cosine(searched["model"].pc, oracle_pc)
    pc_equal = bool(np.array_equal(searched["model"].pc, cached["model"].pc))
    result = {
        "rows": rows, "candidates": [c.chunk_rows for c in candidates], "budget": budget,
        "winner_rows": winner, "trials": searched["trials"],
        "search_launches": searched["launches"], "cache_launches": cached["launches"],
        "fold_chunks": fold_chunks, "search_fit_s": searched["fit_s"],
        "cache_fit_s": cached["fit_s"], "search_source": searched["tuning"]["source"],
        "cache_source": cached["tuning"]["source"],
        "cache_hit": cached["tuning"]["cache_hit"],
        "cache_chunk_rows": cached["tuning"]["config"]["chunk_rows"],
        "min_cosine_vs_f64_oracle": min_cos, "pc_bit_equal": pc_equal,
        "seconds_per_row": seconds_per_row,
    }
    print(f"autotune (b): {json.dumps(result)}", flush=True)
    if result["search_source"] != "search" or not 1 <= searched["trials"] <= budget:
        raise AssertionError(f"the search fit resolved {searched['tuning']} in "
                             f"{searched['trials']} trials (budget {budget})")
    if searched["chunks"] != fold_chunks or searched["fold_calls"] != fold_chunks:
        raise AssertionError(f"the searched fit folded {searched['chunks']} chunks "
                             f"({searched['fold_calls']} booked), not {fold_chunks}")
    if kernel is not None:
        trial_launches = searched["launches"][kernel] - fold_chunks
        if trial_launches != TRIAL_FOLDS * searched["trials"]:
            raise AssertionError(f"{trial_launches} trial launches for "
                                 f"{searched['trials']} trials")
        if cached["launches"][kernel] != fold_chunks:
            raise AssertionError(f"the cached fit launched {cached['launches']}")
    if not min_cos >= COSINE_BAR:
        raise AssertionError(f"searched fit min cosine vs the f64 oracle {min_cos}")
    if (result["cache_source"], result["cache_hit"], result["cache_chunk_rows"]) != (
            "cache", True, winner) or cached["trials"] or not pc_equal:
        raise AssertionError(f"the cached fit is not the searched one: {result}")
    if cached["fold_calls"] != cached["chunks"] or (
            kernel is not None and cached["fold_calls"] != cached["launches"][kernel]):
        raise AssertionError(f"stream.fold_step calls {cached['fold_calls']} != launches")
    return result


# -- phase 20: the Spark glue's device half ----------------------------------

SPARK_LINEAR_ROWS = 1_000_000   # config 2's width, cut from 10,000,000 rows (PERF.md §4)
SPARK_NEWTON_JOBS = 3
SPARK_KMEANS_ROWS = 2_000_000   # config 5's width and k, cut from 50,000,000 rows
SPARK_NAN_SHARE = 0.01
SPARK_SEED = 61
SPARK_STATS_RTOL = 1e-5         # moments and sums against f64, normwise


def spark_frames(columns: dict, partitions: int = LINEAR_PARTITIONS,
                 batches: int = PARTITION_BATCHES) -> list[list[ColumnFrame]]:
    """The rows as ``partitions`` partitions of ``batches`` frames of named
    columns each (views of the host arrays): what a worker's mapInArrow
    body reads, without pyarrow."""
    rows = len(next(iter(columns.values())))
    edges = partition_edges(rows, partitions)
    out = []
    for p in range(partitions):
        sub = partition_edges(int(edges[p + 1] - edges[p]), batches) + edges[p]
        out.append([ColumnFrame({name: v[sub[b]:sub[b + 1]] for name, v in columns.items()})
                    for b in range(batches)])
    return out


def merge_on_host(fn, parts, combine=None) -> dict:
    """A statistics body's ``partition_stats`` over every partition, merged
    in f64 on the host as the driver merges the stats rows (sum, or the
    ``combine`` fold of ``arrow_fns.RANGE_COMBINE``)."""
    merged, fold = None, combine or {}
    for frames in parts:
        stats = fn.partition_stats(frames)
        host = {f: t.double().cpu().numpy() for f, t in zip(stats._fields, stats)}
        merged = host if merged is None else {
            f: fold.get(f, np.add)(merged[f], v) for f, v in host.items()}
    return merged


def _timed_body(device: torch.device, fn, *args):
    _sync(device)
    t0 = time.perf_counter()
    out = fn(*args)
    _sync(device)
    return out, time.perf_counter() - t0


def _normwise(got, want) -> float:
    want = np.asarray(want, dtype=np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want))


def _body_outputs(fn, parts) -> list[np.ndarray]:
    """A transform body's ``map_matrix`` over every frame, each output
    column concatenated in row order."""
    outs = [fn.map_matrix(columnar.extract_matrix(f, fn.input_col))
            for frames in parts for f in frames]
    return [np.concatenate([o[i][1] for o in outs]) for i in range(len(outs[0]))]


def _transform_gate(label: str, got: np.ndarray, want: np.ndarray) -> dict:
    want = np.asarray(want, dtype=np.float64)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    out = {"max_abs_err": err, "tol": SERVE_REL_TOL * float(np.abs(want).max())}
    if got.shape != want.shape or not err <= out["tol"]:
        raise AssertionError(f"phase 20 (d) {label}: the body is off the model's transform {out}")
    return out


def phase_spark_features(rows: int, n: int, k: int, partitions: int,
                         device: torch.device) -> dict:
    """Phase 20 (c), (d): the feature-statistics bodies and TruncatedSVD's
    driver-merge body on phase 4's rows, then each estimator's driver half
    on the card; StandardScaler's transform body."""
    x = bench_workload(rows, n)
    cuda = device.type == "cuda"
    dev = device.type
    parts = spark_frames({"features": x}, partitions)
    xd = torch.from_numpy(x).to(device)
    x64 = xd.double()
    result = {"rows": rows, "n": n, "partitions": partitions, "frames": PARTITION_BATCHES}

    # moments → SparkStandardScaler's driver half
    mom, result["moments_s"] = _timed_body(
        device, merge_on_host, arrow_fns.MomentsPartitionFn("features", device=dev), parts)
    scaler_est = spark_est.SparkStandardScaler(device=device).setInputCol("features")
    mean, std = scaler_est.moments_merged(mom)
    total64, sq64 = x64.sum(0), (x64 * x64).sum(0)
    mean64 = total64 / rows
    std64 = torch.sqrt((sq64 - rows * mean64 * mean64) / (rows - 1))
    result["moments"] = {
        "count": float(mom["count"]),
        "total_rel_err": _normwise(mom["total"], total64.cpu().numpy()),
        "total_sq_rel_err": _normwise(mom["total_sq"], sq64.cpu().numpy()),
        "mean_err_sigmas": float((torch.from_numpy(mean).to(device).double() - mean64).abs().max()
                                 / std64.min()),
        "std_rel_err": float(((torch.from_numpy(std).to(device).double() - std64) / std64)
                             .abs().max()),
    }

    # the range and histogram passes → SparkRobustScaler's driver half
    rng, result["range_s"] = _timed_body(
        device, merge_on_host, arrow_fns.RangeStatsPartitionFn("features", device=dev), parts,
        arrow_fns.RANGE_COMBINE)
    robust_est = spark_est.SparkRobustScaler(device=device).setInputCol("features")
    bins = robust_est.getNumBins()
    hist, result["histogram_s"] = _timed_body(
        device, merge_on_host,
        arrow_fns.HistogramPartitionFn("features", rng["min"], rng["max"], bins, device=dev),
        parts)
    median, qrange = robust_est.robust_merged(rng, hist["hist"])
    xs = torch.sort(xd, dim=0).values.double()

    def exact_quantile(q: float) -> np.ndarray:
        pos = q * (rows - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, rows - 1)
        return (xs[lo] + (pos - lo) * (xs[hi] - xs[lo])).cpu().numpy()

    width = (rng["max"] - rng["min"]) / bins
    exact_range = exact_quantile(robust_est.getUpper()) - exact_quantile(robust_est.getLower())
    result["robust"] = {
        "bins": bins,
        "range_exact": bool(np.array_equal(rng["min"], xs[0].cpu().numpy())
                            and np.array_equal(rng["max"], xs[-1].cpu().numpy())
                            and np.array_equal(rng["max_abs"],
                                               x64.abs().amax(0).cpu().numpy())),
        "hist_rows_per_feature": sorted(set(hist["hist"].sum(1).tolist())),
        "median_err_bins": float((np.abs(median - exact_quantile(0.5)) / width).max()),
        "range_err_bins": float((np.abs(qrange - exact_range) / width).max()),
    }
    del xs

    # NaN-aware moments and range → SparkImputer's driver half
    gen = torch.Generator(device=device).manual_seed(SPARK_SEED)
    missing = torch.rand(xd.shape, generator=gen, device=device) < SPARK_NAN_SHARE
    x_nan = xd.masked_fill(missing, float("nan")).cpu().numpy()
    nan_parts = spark_frames({"features": x_nan}, partitions)
    nm, result["nan_moments_s"] = _timed_body(
        device, merge_on_host,
        arrow_fns.NanMomentsPartitionFn("features", float("nan"), device=dev), nan_parts)
    nr, result["nan_range_s"] = _timed_body(
        device, merge_on_host,
        arrow_fns.NanRangePartitionFn("features", float("nan"), device=dev), nan_parts,
        arrow_fns.RANGE_COMBINE)
    surrogate = spark_est.SparkImputer.surrogate_from_moments(nm)
    valid = ~missing
    count64 = valid.sum(0).double()
    ntotal64 = torch.where(valid, x64, torch.zeros_like(x64)).sum(0)
    inf = torch.full_like(x64, float("inf"))
    result["imputer"] = {
        "missing_share": float(missing.double().mean()),
        "counts_exact": bool(np.array_equal(nm["count"], count64.cpu().numpy())
                             and np.array_equal(nr["count"], count64.cpu().numpy())),
        "range_exact": bool(
            np.array_equal(nr["min"], torch.where(valid, x64, inf).amin(0).cpu().numpy())
            and np.array_equal(nr["max"], torch.where(valid, x64, -inf).amax(0).cpu().numpy())),
        "total_rel_err": _normwise(nm["total"], ntotal64.cpu().numpy()),
        "surrogate_err_sigmas": float(
            (torch.from_numpy(surrogate).to(device) - ntotal64 / count64).abs().max()
            / std64.min()),
    }
    del x_nan, nan_parts, missing, valid, inf

    # SparkTruncatedSVD's driver-merge body at "high": one fused_gram_moments a frame
    reset_launches()
    gram, result["tsvd_stats_s"] = _timed_body(
        device, merge_on_host,
        arrow_fns.FitPartitionFn("features", precision="high", device=dev), parts)
    launches = read_launches()
    tsvd_est = spark_est.SparkTruncatedSVD(device=device).setInputCol("features").setK(k)
    (components, sv), result["tsvd_decompose_s"] = _timed_body(
        device, tsvd_est.decompose_merged, gram["xtx"], k, "gram")
    oracle, _ = oracle_from_scatter((x64.T @ x64).cpu().numpy(), k)
    result["tsvd"] = {"launches": launches, "count": float(gram["count"]),
                      "min_cosine_vs_f64_oracle": _min_abs_cosine(components, oracle),
                      "finite": bool(np.isfinite(sv).all())}
    del x64

    # (d) StandardScaler's transform body against the model's transform, on
    # the first partition (the model's own transform of the 1 GB of rows
    # took 2.9 s on the card: the gate's cost, not the body's)
    model = spark_est.SparkStandardScalerModel(mean=mean, std=std, device=device) \
        .setInputCol("features")
    body = arrow_fns.MatrixMapPartitionFn("features", "scaled", model._scale, device=dev)
    (scaled,), result["scaler_transform_body_s"] = _timed_body(
        device, _body_outputs, body, parts[:1])
    result["scaler_transform"] = _transform_gate("StandardScaler", scaled,
                                                 model.transform(x[:len(scaled)]))
    result["launches"] = launches["gram_moments"]
    print(f"spark glue (c): {json.dumps(result)}", flush=True)

    mo, ro, im, ts = result["moments"], result["robust"], result["imputer"], result["tsvd"]
    if not (mo["count"] == rows and mo["total_rel_err"] <= SPARK_STATS_RTOL
            and mo["total_sq_rel_err"] <= SPARK_STATS_RTOL
            and mo["mean_err_sigmas"] <= SPARK_STATS_RTOL and mo["std_rel_err"] <= SPARK_STATS_RTOL):
        raise AssertionError(f"phase 20 (c) moments off f64: {mo}")
    if not (ro["range_exact"] and ro["hist_rows_per_feature"] == [rows]
            and ro["median_err_bins"] <= 1.0 and ro["range_err_bins"] <= 2.0):
        raise AssertionError(f"phase 20 (c) robust scaler off the exact quantiles: {ro}")
    if not (im["counts_exact"] and im["range_exact"] and im["total_rel_err"] <= SPARK_STATS_RTOL
            and im["surrogate_err_sigmas"] <= SPARK_STATS_RTOL):
        raise AssertionError(f"phase 20 (c) imputer off f64: {im}")
    expected = expected_launches(gram_moments=partitions * PARTITION_BATCHES if cuda else 0)
    if ts["launches"] != expected or ts["count"] != rows:
        raise AssertionError(f"phase 20 (c) TruncatedSVD launches {ts}, expected {expected}")
    if not (ts["min_cosine_vs_f64_oracle"] >= COSINE_BAR and ts["finite"]):
        raise AssertionError(f"phase 20 (c) TruncatedSVD off the f64 oracle: {ts}")
    return result


def phase_spark_linear(x_pool: np.ndarray, device: torch.device, *,
                       rows: int = SPARK_LINEAR_ROWS, jobs: int = SPARK_NEWTON_JOBS,
                       classes: int = SOFTMAX_CLASSES, partitions: int = LINEAR_PARTITIONS,
                       seed: int = LINEAR_SEED) -> dict:
    """Phase 20 (a), (d): the linear bodies on the first ``rows`` of phase
    8's rows (phase 14 (a)'s labels and weights, (b)'s and (c)'s classes),
    merged on the host, each Newton job's merge through the estimator's
    driver half; held to phase 14's f64 oracles and to the core estimators
    on the same rows; the LinearRegression and binary LogisticRegression
    transform bodies."""
    x = x_pool[:rows]
    n = x.shape[1]
    dev = device.type
    lin = linreg_workload(x, device, seed)
    xd = torch.from_numpy(x).to(device)
    yb = _logistic_labels(xd, seed)
    yc = _softmax_labels(xd, classes, seed)
    parts = spark_frames({"features": x, "label": lin["y"], "weight": lin["w"], "binary": yb,
                          "class": yc}, partitions)
    result = {"rows": rows, "n": n, "partitions": partitions, "frames": PARTITION_BATCHES,
              "jobs": jobs, "classes": classes}
    reset_launches()

    merged, result["linreg_stats_s"] = _timed_body(
        device, merge_on_host,
        arrow_fns.LinRegPartitionFn("features", "label", "weight", device=dev), parts)
    linreg_est = spark_est.SparkLinearRegression(device=device).setWeightCol("weight")
    (coef, intercept), result["linreg_solve_s"] = _timed_body(
        device, linreg_est.solve_merged, merged)
    carry = LIN.LinearStats(*(torch.as_tensor(merged[f], device=device)
                              for f in LIN.LinearStats._fields))
    result["linreg"] = linreg_gates(carry, linear_stats_f64(x, lin["y"], lin["w"], device)[1],
                                    coef, intercept)

    logit_est = spark_est.SparkLogisticRegression(device=device, regParam=NEWTON_REG)
    for label, col, n_classes, y in (("binary", "binary", 2, yb),
                                     ("softmax", "class", classes, yc)):
        y_t = torch.from_numpy(y).to(device)
        w = np.zeros((n + 1) * (1 if n_classes == 2 else n_classes))
        job_s = []
        for it in range(jobs):
            if n_classes == 2:
                fn = arrow_fns.LogRegNewtonPartitionFn("features", col, w, device=dev)
            else:
                fn = arrow_fns.SoftmaxNewtonPartitionFn("features", col, w, n_classes, device=dev)
            stats, body_s = _timed_body(device, merge_on_host, fn, parts)
            if it == 0:
                _, grad64, _ = newton_f64(xd, y_t, torch.zeros(len(w), dtype=torch.float64,
                                                              device=device),
                                          NEWTON_REG, None if n_classes == 2 else n_classes,
                                          hessian=False)
                grad_err = _normwise(stats["grad"], grad64.cpu().numpy())
            (w_dev, _), step_s = _timed_body(device, logit_est.newton_step, w, stats, n_classes)
            w = w_dev.cpu().numpy()
            job_s.append(body_s + step_s)
        core = LogisticRegression(device=device, regParam=NEWTON_REG, maxIter=jobs).fit(
            (x, y), num_partitions=partitions)
        w_core = _newton_params(core, None if n_classes == 2 else n_classes)
        if n_classes > 2:
            # the softmax leaves an equal shift of every intercept free
            w, w_core = (np.concatenate([m[:, :-1], m[:, -1:] - m[:, -1:].mean()], 1).reshape(-1)
                         for m in (w.reshape(n_classes, -1), w_core.reshape(n_classes, -1)))
        obj = newton_f64(xd, y_t, torch.from_numpy(w).to(device), NEWTON_REG,
                         None if n_classes == 2 else n_classes, hessian=False)[0]
        obj_core = newton_f64(xd, y_t, torch.from_numpy(w_core).to(device), NEWTON_REG,
                              None if n_classes == 2 else n_classes, hessian=False)[0]
        result[label] = {
            "job_s": job_s, "first_job_grad_rel_err_vs_f64": grad_err,
            "params_rel_err_vs_core": float(np.linalg.norm(w - w_core) / np.linalg.norm(w_core)),
            "obj_rel_err_vs_core": abs(obj - obj_core) / abs(obj_core),
        }
        if label == "binary":
            logit_model = logit_est._model_from_params(w, 2, True)

    # (d) the transform bodies against the models' own transforms
    linreg_model = spark_est.SparkLinearRegressionModel(coefficients=coef, intercept=intercept,
                                                        device=device)
    body = arrow_fns.MatrixMapPartitionFn("features", "prediction",
                                          linreg_model._predict_matrix, device=dev)
    (pred,), result["linreg_transform_body_s"] = _timed_body(device, _body_outputs, body, parts)
    result["linreg_transform"] = _transform_gate("LinearRegression", pred,
                                                 linreg_model.transform(x))
    body = arrow_fns.ProbaPredictionPartitionFn("features", "probability", "prediction",
                                                logit_model.proba_and_predictions, device=dev)
    (proba, labels), result["logistic_transform_body_s"] = _timed_body(
        device, _body_outputs, body, parts)
    want_proba, want_labels = logit_model.proba_and_predictions(x)
    result["logistic_transform"] = _transform_gate("LogisticRegression", proba, want_proba)
    result["logistic_transform"]["labels_equal"] = bool(np.array_equal(labels, want_labels))
    result["launches"] = read_launches()  # cuBLAS products only: no hand kernel
    print(f"spark glue (a): {json.dumps(result)}", flush=True)

    if result["launches"] != expected_launches():
        raise AssertionError(f"phase 20 (a) launched a Gram kernel: {result['launches']}")

    for label in ("binary", "softmax"):
        g = result[label]
        if not g["first_job_grad_rel_err_vs_f64"] <= LINEAR_STATS_RTOL:
            raise AssertionError(f"phase 20 (a) {label}: the first job's gradient off f64 {g}")
        if not (g["params_rel_err_vs_core"] <= NEWTON_GRAD_RTOL
                and g["obj_rel_err_vs_core"] <= NEWTON_OBJ_RTOL):
            raise AssertionError(f"phase 20 (a) {label}: the jobs are off the core fit {g}")
    if not result["logistic_transform"]["labels_equal"]:
        raise AssertionError(f"phase 20 (d) logistic labels: {result['logistic_transform']}")
    return result


def _kmeans_gate(label: str, stats: dict, f64: dict) -> dict:
    """A merged KMeans statistic against an f64 pass (phase 12's gates):
    labels off f64 only at near ties, counts within twice the mismatches of
    the f64 labels' counts, sums and cost within ``KMEANS_RTOL``."""
    counts = torch.from_numpy(np.rint(stats["counts"]).astype(np.int64))
    out = {
        "mismatches": f64["mismatches"], "near_ties": f64["near_ties"],
        "mismatches_not_near_tie": f64["mismatches_not_near_tie"],
        "counts_l1_vs_f64_labels": int((counts - f64["counts_f64_labels"].cpu()).abs().sum()),
        "cost_rel_err": abs(float(stats["cost"]) - f64["cost64"]) / f64["cost64"],
    }
    if "sums" in stats:
        sums64 = f64["sums64"].cpu().numpy()
        out["sums_normwise_err"] = float(np.abs(stats["sums"] - sums64).max()
                                         / np.abs(sums64).max())
    if (out["mismatches_not_near_tie"] or out["counts_l1_vs_f64_labels"] > 2 * out["mismatches"]
            or not out["cost_rel_err"] <= KMEANS_RTOL
            or not out.get("sums_normwise_err", 0.0) <= KMEANS_RTOL):
        raise AssertionError(f"phase 20 (b) {label} off f64: {out}")
    return out


def phase_spark_kmeans(device: torch.device, *, rows: int = SPARK_KMEANS_ROWS,
                       n: int = CONFIG5_N, k: int = CONFIG5_K,
                       partitions: int = LINEAR_PARTITIONS, lloyd_jobs: int = SPARK_NEWTON_JOBS,
                       seed: int = CONFIG5_SEED) -> dict:
    """Phase 20 (b), (d): one k-means‖ round (the cost body, the sample body),
    the weighting body on its candidates and SparkKMeans' weighted k-means++
    driver half, then ``lloyd_jobs`` Lloyd jobs through the Lloyd body and
    the driver's ``lloyd_step``, on config 5's blobs; each merge held to an
    f64 pass with phase 12's near-tie rule; the multi-output transform body."""
    import zlib

    dev = device.type
    x = kmeans_workload(rows, n, k, partitions, device, seed)
    parts = spark_frames({"features": x}, partitions)
    batches = [to_device(f["features"].to_numpy(), device) for frames in parts for f in frames]
    gate_parts = [(b, None, b.shape[0]) for b in batches]
    est = spark_est.SparkKMeans(device=device).setK(k).setSeed(seed)
    result = {"rows": rows, "n": n, "k": k, "partitions": partitions,
              "frames": PARTITION_BATCHES}
    reset_launches()

    c0 = x[np.random.default_rng(seed).integers(rows)][None, :].astype(np.float64)
    cost, result["cost_body_s"] = _timed_body(
        device, merge_on_host, arrow_fns.KMeansAssignStatsFn("features", c0, device=dev), parts)
    c0_t = torch.from_numpy(c0).to(device).float()
    cost64 = sum(float(((b.double() - c0_t.double()) ** 2).sum()) for b in batches)
    result["cost_pass"] = {"count": float(cost["counts"].sum()),
                           "cost_rel_err": abs(float(cost["cost"]) - cost64) / cost64}
    if cost["counts"].sum() != rows or not result["cost_pass"]["cost_rel_err"] <= KMEANS_RTOL:
        raise AssertionError(f"phase 20 (b) the cost body off f64: {result['cost_pass']}")

    ell = 2.0 * k
    phi = float(cost["cost"])
    sample = arrow_fns.KMeansParallelSampleFn("features", c0, ell / phi, seed + 1, device=dev)
    cands, result["sample_body_s"] = _timed_body(
        device, lambda: np.concatenate([sample.partition_candidates(f) for f in parts]))
    drawn, flips, near_ties = [], 0, 0
    tie = f32_dist_error_bound(n)
    for frame, b in zip([f for frames in parts for f in frames], batches):
        mat, mask = sample.sample_mask(frame, device)
        drawn.append(mat[mask])
        b64 = b.double()
        d64 = ((b64 - c0_t.double()) ** 2).sum(1)
        scale = (b64 * b64).sum(1) + float((c0 * c0).sum())
        p64 = torch.clamp(ell / phi * d64, max=1.0).cpu().numpy()
        h = zlib.crc32(np.ascontiguousarray(mat[0], dtype=np.float64).tobytes()) ^ len(mat)
        u = np.random.default_rng([seed + 1, h]).random(len(mat))
        near = np.abs(p64 - u) <= ell / phi * tie * scale.cpu().numpy()
        flips += int(((mask != (u < p64)) & ~near).sum())
        near_ties += int(near.sum())
    result["sample"] = {"candidates": int(len(cands)), "expected": ell, "flips_not_near_tie": flips,
                        "near_ties": near_ties,
                        "bodies_agree": bool(np.array_equal(np.concatenate(drawn), cands))}
    candidates = np.concatenate([c0, cands.astype(np.float64)])
    weights, result["weighting_body_s"] = _timed_body(
        device, merge_on_host,
        arrow_fns.KMeansAssignStatsFn("features", candidates, device=dev), parts)
    cand_t = torch.from_numpy(candidates).to(device).float()
    result["weighting_pass"] = _kmeans_gate(
        "the weighting body", weights,
        kmeans_f64_pass(gate_parts, cand_t, block_rows_for(device, KM.DEFAULT_BLOCK_ROWS,
                                                           len(candidates))))
    centers, result["reduce_s"] = _timed_body(device, est.reduce_candidates, candidates,
                                              weights["counts"], k)

    block = block_rows_for(device, KM.DEFAULT_BLOCK_ROWS, k)
    result["lloyd"] = []
    for it in range(lloyd_jobs):
        stats, body_s = _timed_body(
            device, merge_on_host, arrow_fns.KMeansPartitionFn("features", centers, device=dev),
            parts)
        gate = _kmeans_gate(f"Lloyd job {it}", stats, kmeans_f64_pass(
            gate_parts, torch.from_numpy(centers).to(device).float(), block))
        (centers, _, shift), step_s = _timed_body(device, est.lloyd_step, centers, stats)
        result["lloyd"].append({**gate, "body_s": body_s, "step_s": step_s, "shift_sq": shift})
    del batches, gate_parts

    # (d) the multi-output transform body: prediction and squared distance
    model = spark_est.SparkKMeansModel(clusterCenters=centers, device=device)

    def labels_and_d2(mat, _m=model):
        got = [(lab.cpu().numpy(), d2.cpu().numpy()) for lab, d2 in _m._assign_chunks(mat)]
        return np.concatenate([g[0] for g in got]), np.concatenate([g[1] for g in got])

    body = arrow_fns.MultiOutputPartitionFn(
        "features", [("prediction", np.int32), ("distance", np.float64)], labels_and_d2,
        device=dev)
    (pred, d2), result["transform_body_s"] = _timed_body(device, _body_outputs, body, parts)
    result["transform"] = _transform_gate("KMeans", pred, model.transform(x))
    result["launches"] = read_launches()  # cuBLAS products only: no hand kernel
    print(f"spark glue (b): {json.dumps(result)}", flush=True)

    if result["launches"] != expected_launches():
        raise AssertionError(f"phase 20 (b) launched a Gram kernel: {result['launches']}")

    sm = result["sample"]
    if sm["flips_not_near_tie"] or not sm["bodies_agree"] or not 0 < sm["candidates"]:
        raise AssertionError(f"phase 20 (b) the sample body off the f64 trials: {sm}")
    if centers.shape != (k, n) or not np.isfinite(centers).all() or not np.isfinite(d2).all():
        raise AssertionError("phase 20 (b) fitted non-finite centres")
    return result


# -- phase 21: the mesh ------------------------------------------------------------

MESH_ROWS = 2_000_000       # (a): config 2's width in four data shards on one card
MESH_SHARDS = 4
MESH_TSQR_ROWS = 1_000_000  # (c)
MESH_SKETCH_OVERSAMPLE = 20  # l = k + 20 = 70 spans the workload's rank-64 signal
MESH_BARRIER_RANKS = 4      # (d): four processes on one card over gloo
MESH_BARRIER_FRAMES = 8     # phase 4's rows in 8 frames, 2 a rank
MESH_HIST_BINS = 64
MESH_STATS_TOL = 1e-5       # × max, against the one-device (or in-process) statistics
MESH_F64_TOL = 3e-5         # × max, "high" against f64: the split's bound, as in the tests


def tsqr_ev_tol(n: int) -> float:
    """The f32 TSQR's bound on explainedVariance, × its largest ratio: each
    singular value moves by up to c·2⁻²⁴·σ_max (Weyl, Householder QR's
    backward error; c = 8), so Σs over the n of them by n·c·2⁻²⁴·σ_max."""
    return 8.0 * n * 2.0**-24
MESH_SEED = 13


def _rel(got, want) -> float:
    """max |got − want| / max |want|, on the host in f64."""
    got = got.detach().double().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(
        got, np.float64)
    want = want.detach().double().cpu().numpy() if isinstance(want, torch.Tensor) else np.asarray(
        want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _f64_column_stats(x: torch.Tensor, chunk: int = 1 << 18) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σx, Σx²) per column in f64 on x's device, a chunk at a time."""
    total = torch.zeros(x.shape[1], dtype=torch.float64, device=x.device)
    total_sq = torch.zeros_like(total)
    for a in range(0, x.shape[0], chunk):
        part = x[a:a + chunk].double()
        total += part.sum(0)
        total_sq += (part * part).sum(0)
    return total, total_sq


def phase_mesh_inprocess(x_host: np.ndarray, gram64: np.ndarray, k: int, device: torch.device,
                         shards: int = MESH_SHARDS, bins: int = MESH_HIST_BINS) -> dict:
    """Phase 21 (a): the in-process mesh at config 2's width: the rows in
    ``shards`` data shards on one device at "high". ``sharded_gram_stats``
    (one fused_gram_moments launch a shard, read from 0 around exactly it)
    against the one-device ``gram_stats`` of the same rows (1e-5 × max) and
    f64 (3e-5 × max); ``distributed_pca_fit`` (k) and the ring Gram at data
    = feat = 2 against f64; moments against f64 (1e-5 × max), ranges and the
    histogram's counts exactly the one-device ones."""
    cuda = device.type == "cuda"
    rows, n = x_host.shape
    x = torch.from_numpy(x_host).to(device)
    mesh = MM.create_mesh(data=shards, devices=[device] * shards)
    oracle_pc, _ = oracle_from_scatter(gram64, k)
    one = L.gram_stats(x, precision="high")  # also the kernels' warm-up
    _sync(device)
    reset_launches()
    t0 = time.perf_counter()
    stats = MG.sharded_gram_stats(x, mesh, precision="high")
    _sync(device)
    stats_s = time.perf_counter() - t0
    launches = read_launches()
    t0 = time.perf_counter()
    pc, _ = MG.distributed_pca_fit(x, k, mesh, precision="high")
    _sync(device)
    fit_s = time.perf_counter() - t0
    ring_mesh = MM.create_mesh(data=2, feat=2, devices=[device] * 4)
    t0 = time.perf_counter()
    ring, ring_sum, ring_count = MG.ring_gram(x, ring_mesh, precision="high")
    _sync(device)
    ring_s = time.perf_counter() - t0
    total64, total_sq64 = _f64_column_stats(x)
    moments = MG.sharded_moment_stats(x, mesh)
    w = torch.ones(rows, device=device)
    ranges = MG.sharded_range_stats(x, w, mesh)
    hist = MG.sharded_histogram(x, w, ranges.min, ranges.max, bins=bins, mesh=mesh)
    hist_one = sum(SCL.histogram_stats(part, part.shape[0], ranges.min, ranges.max, bins=bins)
                   for part in torch.split(x, 1 << 19))
    result = {
        "rows": rows, "n": n, "k": k, "shards": shards, "launches": launches,
        "stats_s": stats_s, "fit_s": fit_s, "ring_s": ring_s,
        "xtx_rel_vs_one_device": _rel(stats.xtx, one.xtx),
        "xtx_rel_vs_f64": _rel(stats.xtx, gram64),
        "col_sum_rel_vs_f64": _rel(stats.col_sum, total64),
        "count": float(stats.count),
        "min_cosine_vs_f64_oracle": _min_abs_cosine(pc.cpu().numpy(), oracle_pc),
        "ring_xtx_rel_vs_f64": _rel(ring, gram64),
        "ring_col_sum_rel_vs_f64": _rel(ring_sum, total64),
        "moments_total_rel_vs_f64": _rel(moments.total, total64),
        "moments_total_sq_rel_vs_f64": _rel(moments.total_sq, total_sq64),
        "ranges_exact": bool(torch.equal(ranges.min, x.amin(0)) and torch.equal(ranges.max, x.amax(0))
                             and torch.equal(ranges.max_abs, x.abs().amax(0))
                             and float(ranges.count) == rows),
        "histogram_exact": bool(torch.equal(hist, hist_one) and bool((hist.sum(1) == rows).all())),
    }
    print(f"mesh (a) in-process: {json.dumps(result)}", flush=True)
    expected = expected_launches(gram_moments=shards if cuda else 0)
    if launches != expected:
        raise AssertionError(f"sharded_gram_stats launched {launches}, expected {expected}")
    for key, bound in (("xtx_rel_vs_one_device", MESH_STATS_TOL), ("xtx_rel_vs_f64", MESH_F64_TOL),
                       ("col_sum_rel_vs_f64", MESH_STATS_TOL), ("ring_xtx_rel_vs_f64", MESH_F64_TOL),
                       ("ring_col_sum_rel_vs_f64", MESH_STATS_TOL),
                       ("moments_total_rel_vs_f64", MESH_STATS_TOL),
                       ("moments_total_sq_rel_vs_f64", MESH_STATS_TOL)):
        if not result[key] <= bound:
            raise AssertionError(f"mesh (a): {key} = {result[key]} > {bound}")
    if not (result["count"] == float(ring_count) == rows and result["ranges_exact"]
            and result["histogram_exact"]):
        raise AssertionError(f"mesh (a): counts, ranges or histogram not exact: {result}")
    if not result["min_cosine_vs_f64_oracle"] >= COSINE_BAR:
        raise AssertionError(f"mesh (a): distributed fit vs the f64 oracle: {result}")
    return result


def _mesh_fold(x: np.ndarray, mesh, n: int, device: torch.device):
    """``x`` streamed through the per-shard chunk fold on ``mesh`` at
    "high" and finalized: (stats, StreamFold)."""
    res = ingest.stream_fold(
        [x], lambda c, xc, wc: MG.sharded_gram_fold(c, xc, wc, mesh, precision="high"), n=n,
        init=MG.init_chunk_carry(L.init_gram_carry(n, "meta"), mesh), device=mesh.first_device,
        chunk_rows=MG.stream_chunk_rows_for_mesh(mesh), put_fn=MG.chunk_put(mesh),
        min_chunk_rows=mesh.shape[MM.DATA_AXIS],
    )
    return MG.finalize_chunk_fold(res.carry, mesh), res


def phase_mesh_streamed(data, k: int, device: torch.device, shards: int = MESH_SHARDS,
                        phase8_fit_s: float | None = None) -> dict:
    """Phase 21 (b): phase 8's rows streamed through ``sharded_gram_fold``
    on the mesh-local fit's own mesh (``_mesh_or_fallback``: every card, one
    here) and on ``shards`` shards of the card, each finalized by one
    allreduce and decomposed (k); ``symmetric_gram_moments`` launched once a
    shard a chunk (read from 0 around each fold). Statistics against the
    one-device fold of phase 8's fit (1e-5 × max), components against the
    f64 oracle, ``degraded.cpu_fallback`` 0, fit seconds beside phase 8's."""
    x, gram64 = data
    rows, n = x.shape
    cuda = device.type == "cuda"
    chunk = ingest.stream_chunk_rows()
    chunks = -(-rows // chunk)
    oracle_pc, _ = oracle_from_scatter(gram64, k)
    s0 = REGISTRY.snapshot()
    t0 = time.perf_counter()
    one = ingest.stream_fold([x], L.gram_fold_step("high"), n=n,
                             init=L.init_gram_carry(n, device), device=device).carry
    _sync(device)
    one_device_s = time.perf_counter() - t0
    result = {"rows": rows, "n": n, "k": k, "chunks": chunks, "one_device_fold_s": one_device_s,
              "phase8_fit_s": phase8_fit_s}
    meshes = (("own_mesh", spark_est._mesh_or_fallback(device)),
              ("four_shards", MM.create_mesh(devices=[device] * shards)))
    for label, mesh in meshes:
        if mesh is None:
            raise AssertionError("mesh creation fell back to the one-device fold")
        reset_launches()
        t0 = time.perf_counter()
        stats, res = _mesh_fold(x, mesh, n, device)
        pc, _ = L.pca_fit_from_cov(L.covariance_from_stats(stats, mean_centering=False), k)
        _sync(device)
        fit_s = time.perf_counter() - t0
        launches = read_launches()
        shard_count = mesh.shape[MM.DATA_AXIS]
        entry = {
            "shards": shard_count, "fit_s": fit_s, "launches": launches,
            "chunks": res.chunks, "copy_overlapped": res.copy_overlapped,
            "xtx_rel_vs_one_device": _rel(stats.xtx, one.xtx),
            "col_sum_rel_vs_one_device": _rel(stats.col_sum, one.col_sum),
            "count": float(stats.count),
            "min_cosine_vs_f64_oracle": _min_abs_cosine(pc.cpu().numpy(), oracle_pc),
        }
        result[label] = entry
        expected = expected_launches(
            symmetric_gram_moments=chunks * shard_count if cuda else 0)
        if launches != expected or res.chunks != chunks:
            raise AssertionError(f"mesh (b) {label}: launches {launches}, expected {expected}")
        if not (entry["xtx_rel_vs_one_device"] <= MESH_STATS_TOL
                and entry["col_sum_rel_vs_one_device"] <= MESH_STATS_TOL
                and entry["count"] == rows):
            raise AssertionError(f"mesh (b) {label}: statistics off the one-device fold: {entry}")
        if not entry["min_cosine_vs_f64_oracle"] >= COSINE_BAR:
            raise AssertionError(f"mesh (b) {label}: components vs the f64 oracle: {entry}")
    result["degraded_cpu_fallback"] = REGISTRY.snapshot().delta(s0).counter(
        "degraded.cpu_fallback")
    print(f"mesh (b) streamed: {json.dumps(result)}", flush=True)
    if result["degraded_cpu_fallback"] != 0:
        raise AssertionError("mesh (b): the fit degraded to the one-device fold")
    return result


def phase_mesh_tsqr_sketch(x_host: np.ndarray, k: int, device: torch.device,
                           shards: int = MESH_SHARDS,
                           oversample: int = MESH_SKETCH_OVERSAMPLE) -> dict:
    """Phase 21 (c): ``distributed_pca_fit_svd`` (the butterfly TSQR and the
    SVD of R) over ``shards`` shards and ``sketched_pca_fit`` at data = feat
    = 2, each against the f64 oracle of the same rows (min |cosine| ≥
    0.9999). The sketch's l = k + ``oversample`` spans the data's rank-64
    signal."""
    rows, n = x_host.shape
    x = torch.from_numpy(x_host).to(device)
    oracle_pc, oracle_ev = oracle_from_scatter(scatter_f64(x_host, device), k)
    mesh = MM.create_mesh(data=shards, devices=[device] * shards)
    t0 = time.perf_counter()
    pc, ev = MT.distributed_pca_fit_svd(x, k, mesh)
    _sync(device)
    tsqr_s = time.perf_counter() - t0
    grid = MM.create_mesh(data=2, feat=2, devices=[device] * 4)
    t0 = time.perf_counter()
    spc, sev = MSK.sketched_pca_fit(x, k, grid, oversample=oversample)
    _sync(device)
    sketch_s = time.perf_counter() - t0
    result = {
        "rows": rows, "n": n, "k": k, "shards": shards, "tsqr_s": tsqr_s,
        "sketch_s": sketch_s, "oversample": oversample,
        "tsqr_min_cosine_vs_f64_oracle": _min_abs_cosine(pc.cpu().numpy(), oracle_pc),
        "tsqr_ev_rel_vs_f64": _rel(ev, oracle_ev),
        "tsqr_ev_tol": tsqr_ev_tol(n),
        "sketch_min_cosine_vs_f64_oracle": _min_abs_cosine(spc.cpu().numpy(), oracle_pc),
    }
    print(f"mesh (c) tsqr and sketched: {json.dumps(result)}", flush=True)
    if not result["tsqr_ev_rel_vs_f64"] <= result["tsqr_ev_tol"]:
        raise AssertionError(f"mesh (c): the TSQR's explainedVariance vs f64: {result}")
    for key in ("tsqr_min_cosine_vs_f64_oracle", "sketch_min_cosine_vs_f64_oracle"):
        if not result[key] >= COSINE_BAR:
            raise AssertionError(f"mesh (c): {key} = {result[key]} < {COSINE_BAR}")
    return result


class StoreBarrierContext:
    """A barrier context for bodies run outside Spark: ``allGather`` rides
    a ``torch.distributed.TCPStore`` that the parent opened (one key a rank
    a round; ``get`` waits for each)."""

    def __init__(self, rank: int, size: int, port: int):
        import datetime

        self.rank, self.size, self.round = rank, size, 0
        self.store = torch.distributed.TCPStore(
            "127.0.0.1", port, size + 1, False, timeout=datetime.timedelta(seconds=300))

    def partitionId(self) -> int:
        return self.rank

    def getTaskInfos(self) -> list:
        import types

        return [types.SimpleNamespace(address="127.0.0.1")] * self.size

    def allGather(self, message: str = "") -> list[str]:
        key = f"round{self.round}"
        self.round += 1
        self.store.set(f"{key}/{self.rank}", message)
        return [self.store.get(f"{key}/{r}").decode() for r in range(self.size)]


def _mesh_barrier_rank(rank: int, size: int, port: int, path: str, frames: int, k: int,
                       device_type: str, q) -> None:
    """One rank of phase 21 (d), in a spawned process: its frames of the
    rows through the Gram and TSQR barrier bodies; its rows, or its error,
    go to ``q``."""
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        x = np.load(path, mmap_mode="r")
        edges = partition_edges(len(x), frames)
        per = frames // size
        batches = [ColumnFrame({"features": np.ascontiguousarray(x[edges[f]:edges[f + 1]])})
                   for f in range(rank * per, (rank + 1) * per)]
        ctx = StoreBarrierContext(rank, size, port)
        reset_launches()
        gram = spmd.MeshGramPartitionFn("features", precision="high",
                                        device=device_type).mesh_arrays(batches, ctx)
        svd = spmd.MeshSVDFitFn("features", k, False, device=device_type).mesh_arrays(batches, ctx)
        q.put((rank, gram, svd, read_launches(), None))
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        import traceback

        q.put((rank, None, None, None, traceback.format_exc()))


def phase_mesh_barrier(x_host: np.ndarray, k: int, device: torch.device,
                       ranks: int = MESH_BARRIER_RANKS, frames: int = MESH_BARRIER_FRAMES) -> dict:
    """Phase 21 (d): ``MeshGramPartitionFn`` (at "high") and ``MeshSVDFitFn``
    in ``ranks`` spawned processes on one device, over gloo (CUDA tensors on
    the card), their rendezvous through a stub barrier context on a
    TCPStore, on ``frames`` frames of phase 4's rows. Only rank 0 yields;
    its rows against the in-process mesh program over the same rows and
    against f64: the Gram within 1e-5 × max (3e-5 of f64), the TSQR fit
    min |cosine| ≥ 0.9999 and explainedVariance within ``tsqr_ev_tol``
    (two f32 TSQRs of the same rows sat 8.5e-5 apart on the card). Each
    rank launches fused_gram_moments once."""
    import datetime
    import multiprocessing as mp

    cuda = device.type == "cuda"
    rows, n = x_host.shape
    store = torch.distributed.TCPStore("127.0.0.1", 0, ranks + 1, True,
                                       timeout=datetime.timedelta(seconds=300),
                                       wait_for_workers=False)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-mesh-") as tmp:
        path = os.path.join(tmp, "rows.npy")
        np.save(path, x_host)
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_mesh_barrier_rank,
                             args=(r, ranks, store.port, path, frames, k, device.type, q))
                 for r in range(ranks)]
        for p in procs:
            p.start()
        try:
            results = sorted((q.get(timeout=600) for _ in procs), key=lambda t: t[0])
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
        stage_s = time.perf_counter() - t0
    errors = [err for *_, err in results if err]
    if errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"mesh (d): a rank failed: {errors or [p.exitcode for p in procs]}")
    yielded = [r for r, gram, svd, _, _ in results if gram is not None or svd is not None]
    x = torch.from_numpy(x_host).to(device)
    mesh = MM.create_mesh(data=ranks, devices=[device] * ranks)
    stats = MG.sharded_gram_stats(x, mesh, precision="high")
    pc, ev = MT.distributed_pca_fit_svd(x, k, mesh)
    gram64 = scatter_f64(x_host, device)
    oracle_pc, oracle_ev = oracle_from_scatter(gram64, k)
    gram, svd = results[0][1], results[0][2]
    launches = {name: sum(r[3][name] for r in results) for name in KERNELS}
    result = {
        "rows": rows, "n": n, "k": k, "ranks": ranks, "frames": frames, "stage_s": stage_s,
        "yielding_ranks": yielded, "launches": launches,
        "count": float(gram["count"]), "mesh_size": float(gram["mesh_size"]),
        "xtx_rel_vs_in_process": _rel(gram["xtx"], stats.xtx),
        "xtx_rel_vs_f64": _rel(gram["xtx"], gram64),
        "svd_min_cosine_vs_in_process": _min_abs_cosine(svd["pc"], pc.cpu().numpy()),
        "svd_ev_rel_vs_in_process": _rel(svd["explainedVariance"], ev),
        "svd_ev_rel_vs_f64": _rel(svd["explainedVariance"], oracle_ev),
        "svd_ev_tol": tsqr_ev_tol(n),
        "svd_min_cosine_vs_f64_oracle": _min_abs_cosine(svd["pc"], oracle_pc),
    }
    print(f"mesh (d) barrier: {json.dumps(result)}", flush=True)
    if yielded != [0]:
        raise AssertionError(f"mesh (d): ranks {yielded} yielded rows, expected rank 0 alone")
    if launches != expected_launches(gram_moments=ranks if cuda else 0):
        raise AssertionError(f"mesh (d): the ranks launched {launches}")
    if not (result["count"] == rows and result["mesh_size"] == ranks
            and result["xtx_rel_vs_in_process"] <= MESH_STATS_TOL
            and result["xtx_rel_vs_f64"] <= MESH_F64_TOL
            and result["svd_ev_rel_vs_in_process"] <= result["svd_ev_tol"]
            and result["svd_ev_rel_vs_f64"] <= result["svd_ev_tol"]
            and result["svd_min_cosine_vs_in_process"] >= COSINE_BAR
            and result["svd_min_cosine_vs_f64_oracle"] >= COSINE_BAR):
        raise AssertionError(f"mesh (d): the barrier rows are off: {result}")
    return result


# -- phase 22: the mesh fits ---------------------------------------------------------

MESHFIT_LINEAR_ROWS = 2_000_000   # (a): phase 8's rows, cut from 10,000,000 (f64 gate)
MESHFIT_NEWTON_ROWS = 1_000_000   # (b)
MESHFIT_NEWTON_REG = 0.1          # where converged f32 Newton iterates agree to ~1e-7
MESHFIT_NEWTON_ITER = 25
# The squared hinge's Hessian counts the rows inside the margin, so two
# converged f32 fits whose statistics were summed in other orders may
# settle on active sets that differ in rows at the kink: 5.1e-5 × max
# apart on the card (each at an f64 gradient of ~1e-8 of its start's).
MESHFIT_HINGE_TOL = 1e-4
MESHFIT_BARRIER_SOFTMAX_ITER = 8  # (g): its f64 gradient is 1e-8 of the start's by then
MESHFIT_SOFTMAX_ITERS = 3
MESHFIT_CHUNK_ITERS = 2           # (b), (c): the chunked runs' iterations a chunk
MESHFIT_KMEANS_ROWS = 2_000_000   # (c): config 5's blobs, cut from 50,000,000
MESHFIT_LLOYD_ITERS = 5
MESHFIT_DBSCAN_GRIDS = 100        # (d): 40,000 lattice rows, cut from phase 13's 100,000
MESHFIT_KNN_QUERIES = 4_096       # (d): phase 13's 1,000,000-row corpus, 4,096 queries
MESHFIT_FOREST_ROWS = 1_000_000   # (e): HIGGS-shaped rows, cut from 11,000,000
MESHFIT_FOREST_TREES = 5
MESHFIT_NB_ROWS = 500_000         # (e): phase 16's counts, cut from 2,000,000
MESHFIT_ANN_ROWS = 2_000_000      # (f): SIFT-shaped rows, cut from 10,000,000
MESHFIT_BARRIER_ROWS = 500_000    # (g): phase 8's first rows in 8 frames, 2 a rank
MESHFIT_BARRIER_CLASSES = 3
MESHFIT_BARRIER_K = 16


def _augmented_stats(s) -> LIN.LinearStats:
    """LinearStats of [X, 1] from those of X: the ones column's products
    are the weighted column sums and the weight total."""
    n = s.xtx.shape[0]
    xtx = torch.zeros((n + 1, n + 1), dtype=s.xtx.dtype, device=s.xtx.device)
    xtx[:n, :n] = s.xtx
    xtx[:n, n] = xtx[n, :n] = s.x_sum
    xtx[n, n] = s.count
    return LIN.LinearStats(xtx, torch.cat([s.xty, s.y_sum.reshape(1)]),
                           torch.cat([s.x_sum, s.count.reshape(1)]), s.y_sum, s.y_sq, s.count)


def _stats_rel(got, want) -> float:
    """The largest of the fields' ``_rel`` (max |Δ| over max |want|)."""
    return max(_rel(g, w) for g, w in zip(got, want))


def phase_meshfit_linear(x: np.ndarray, linreg: dict, device: torch.device, *,
                         rows: int = MESHFIT_LINEAR_ROWS, shards: int = MESH_SHARDS) -> dict:
    """Phase 22 (a): ``sharded_linear_stats_weighted`` over four shards of
    the card on the first ``rows`` of phase 8's rows with phase 14's labels
    and weights, against the one-device ``linear_stats`` (1e-5 × max) and,
    through phase 14's perturbation bound, f64; then config 2 whole through
    the per-shard ``sharded_linear_fold`` with the intercept column appended
    by the streamed fold, against phase 14's one-device weighted carry with
    the ones column's products added (1e-5 × max) and, through the bound,
    its f64 oracle."""
    n = x.shape[1]
    y, w = linreg["y"], linreg["w"]
    mesh = MM.create_mesh(data=shards, devices=[device] * shards)
    xd = torch.from_numpy(x[:rows]).to(device)
    yd = torch.from_numpy(y[:rows]).to(device)
    wd = torch.from_numpy(w[:rows].astype(np.float32)).to(device)
    one = LIN.linear_stats(xd, yd, wd)
    _sync(device)
    reset_launches()
    t0 = time.perf_counter()
    stats = MPL.sharded_linear_stats_weighted(xd, yd, wd, mesh)
    _sync(device)
    stats_s = time.perf_counter() - t0
    launches = {"sharded_linear_stats": read_launches()}
    del xd, yd, wd
    oracle = linear_stats_f64(x[:rows], y[:rows], w[:rows], device)[1]
    coef, b0 = LIN.solve_from_stats(LIN.as_f64(stats))
    result = {"rows": rows, "n": n, "shards": shards, "stats_s": stats_s,
              "stats_rel_vs_one_device": _stats_rel(stats, one),
              "stats_gates_vs_f64": linreg_gates(LIN.as_f64(stats), oracle, coef.cpu().numpy(),
                                                 float(b0), stats_rtol=None)}

    reset_launches()
    t0 = time.perf_counter()
    res = ingest.stream_fold(
        [(x, y, w)], lambda c, xc, yc, wc: MG.sharded_linear_fold(c, xc, yc, wc, mesh), n=n,
        label_col="label", init=MG.init_chunk_carry(LIN.init_linear_carry(n + 1, "meta"), mesh),
        device=device, chunk_rows=MG.stream_chunk_rows_for_mesh(mesh),
        put_fn=MG.chunk_put(mesh), min_chunk_rows=shards, augment_intercept=True,
    )
    fold = MG.finalize_chunk_fold(res.carry, mesh)
    _sync(device)
    fold_s = time.perf_counter() - t0
    launches["sharded_linear_fold"] = read_launches()
    want = _augmented_stats(linreg["weighted_carry"])
    plain = LIN.LinearStats(fold.xtx[:n, :n], fold.xty[:n], fold.x_sum[:n], fold.y_sum,
                            fold.y_sq, fold.count)
    coef, b0 = LIN.solve_from_stats(LIN.as_f64(plain))
    result.update({
        "fold_rows": len(x), "fold_chunks": res.chunks, "fold_s": fold_s,
        "fold_rel_vs_one_device": _stats_rel(fold, want),
        "fold_gates_vs_f64": linreg_gates(LIN.as_f64(plain), linreg["weighted_oracle"],
                                          coef.cpu().numpy(), float(b0)),
        "launches": launches,
    })
    print(f"meshfit (a) linear: {json.dumps(result)}", flush=True)
    for key in ("stats_rel_vs_one_device", "fold_rel_vs_one_device"):
        if not result[key] <= MESH_STATS_TOL:
            raise AssertionError(f"meshfit (a): {key} = {result[key]} > {MESH_STATS_TOL}")
    if any(v != expected_launches() for v in launches.values()):
        raise AssertionError(f"meshfit (a) launched a Gram kernel: {launches}")
    return result


def _centred_classes(w: np.ndarray, classes: int) -> np.ndarray:
    """Softmax parameters with their class mean taken out: adding one vector
    to every class changes no probability."""
    w = np.asarray(w, np.float64).reshape(classes, -1)
    return w - w.mean(axis=0)


class _ChunkKilled(RuntimeError):
    """A chunked mesh run stopped from outside after its first chunk."""


def _dies_after_first(chunk):
    calls = {"n": 0}

    def run(*args):
        calls["n"] += 1
        if calls["n"] == 2:
            raise _ChunkKilled("killed after the first chunk")
        return chunk(*args)

    return run


def _chunked_resume(run_chunked, chunk, args: tuple, start, *, max_iter: int, tol: float,
                    key: str) -> dict:
    """A chunked run killed after its first chunk and resumed from its
    checkpoint, against the uninterrupted chunked run: bit-equal."""
    full = run_chunked(chunk, *args, start, start_iter=0, max_iter=max_iter, tol=tol, ckpt=None)
    tmp = tempfile.mkdtemp(prefix="meshfit")
    try:
        try:
            run_chunked(_dies_after_first(chunk), *args, start, start_iter=0, max_iter=max_iter,
                        tol=tol, ckpt=TrainingCheckpointer(tmp))
            raise AssertionError("the killed chunked run ran to its end")
        except _ChunkKilled:
            pass
        step, arrays, state = TrainingCheckpointer(tmp).latest()
        extra = {"cost0": state["cost"]} if "cost" in state else {}
        resumed = run_chunked(chunk, *args, torch.from_numpy(arrays[key]), start_iter=step + 1,
                              max_iter=max_iter, tol=tol, ckpt=TrainingCheckpointer(tmp), **extra)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    equal = bool(torch.equal(resumed[0].cpu(), full[0].cpu())) and resumed[1:] == full[1:]
    return {"checkpoint_step": step, "iterations": full[-1], "resumed_iterations": resumed[-1],
            "equal_to_uninterrupted": equal}


def phase_meshfit_newton(x_pool: np.ndarray, device: torch.device, *,
                         rows: int = MESHFIT_NEWTON_ROWS, classes: int = SOFTMAX_CLASSES,
                         softmax_iters: int = MESHFIT_SOFTMAX_ITERS, shards: int = MESH_SHARDS,
                         partitions: int = LINEAR_PARTITIONS, seed: int = LINEAR_SEED) -> dict:
    """Phase 22 (b): on the first ``rows`` of phase 8's rows in four shards
    of the card, the whole-loop binary logistic and squared-hinge fits
    (``make_distributed_logreg_fit``) against the port's LogisticRegression
    and LinearSVC on the same rows at ``regParam`` 0.1 (1e-5 × max, the
    squared hinge ``MESHFIT_HINGE_TOL``) and each at an f64 gradient within
    ``NEWTON_GRAD_RTOL`` of its start's; ``softmax_iters`` iterations of the
    ``classes``-class fit against the core estimator's as many
    (class-centred parameters, 1e-4 × max: unconverged iterates from f32
    statistics summed in another order); the chunked binary fit killed
    after one chunk and resumed, bit-equal."""
    n = x_pool.shape[1]
    mesh = MM.create_mesh(data=shards, devices=[device] * shards)
    x = x_pool[:rows]
    xd = torch.from_numpy(x).to(device)
    xa = torch.cat([xd, torch.ones((rows, 1), device=device)], 1)
    del xd
    ones = torch.ones(rows, device=device)
    y = _logistic_labels(xa[:, :n], seed)
    yd = torch.from_numpy(y).float().to(device)
    reg = MESHFIT_NEWTON_REG
    result = {"rows": rows, "d": n + 1, "shards": shards, "reg": reg}
    reset_launches()
    for label, loss, cls in (("logistic", "logistic", LogisticRegression),
                             ("squared_hinge", "squared_hinge", LinearSVC)):
        fit = MPL.make_distributed_logreg_fit(mesh, reg_param=reg, max_iter=MESHFIT_NEWTON_ITER,
                                              tol=1e-6, loss=loss)
        _sync(device)
        t0 = time.perf_counter()
        w_mesh, iters, step = fit(xa, yd, ones)
        _sync(device)
        mesh_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        core = cls(device=device, regParam=reg, maxIter=MESHFIT_NEWTON_ITER, tol=1e-6).fit(
            (x, y), num_partitions=partitions)
        _sync(device)
        core_s = time.perf_counter() - t0
        want = _newton_params(core, None)
        y64 = torch.from_numpy(y).to(device)
        if loss == "logistic":
            grad = newton_f64(xa[:, :n], y64, w_mesh, reg, hessian=False)[1]
            grad0 = newton_f64(xa[:, :n], y64, torch.zeros_like(w_mesh), reg, hessian=False)[1]
            grad_rel = float(torch.linalg.norm(grad) / torch.linalg.norm(grad0))
        else:
            grad_rel = svc_grad_rel_f64(xa[:, :n], y64, w_mesh, reg)
        result[label] = {"mesh_s": mesh_s, "iterations": int(iters), "final_step": float(step),
                         "s_per_iteration": mesh_s / max(int(iters), 1), "core_fit_s": core_s,
                         "rel_vs_core": _rel(w_mesh, want), "grad_rel_f64": grad_rel}
    chunk = MPL.make_distributed_logreg_chunk(mesh, reg_param=reg, chunk_iters=MESHFIT_CHUNK_ITERS,
                                              tol=0.0)
    result["resume"] = _chunked_resume(
        MPL.run_chunked_newton, chunk, (xa, yd, ones), np.zeros(n + 1),
        max_iter=3 * MESHFIT_CHUNK_ITERS, tol=0.0, key="w")
    ys = _softmax_labels(xa[:, :n], classes, seed)
    ysd = torch.from_numpy(ys).float().to(device)
    fit = MPL.make_distributed_softmax_fit(mesh, classes, reg_param=reg, max_iter=softmax_iters,
                                           tol=0.0)
    _sync(device)
    t0 = time.perf_counter()
    w_soft, iters, _ = fit(xa, ysd, ones)
    _sync(device)
    soft_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    core = LogisticRegression(device=device, regParam=reg, maxIter=softmax_iters, tol=0.0).fit(
        (x, ys), num_partitions=partitions)
    _sync(device)
    core_s = time.perf_counter() - t0
    got_c = _centred_classes(w_soft.cpu().numpy(), classes)
    want_c = _centred_classes(_newton_params(core, classes), classes)
    result["softmax"] = {"classes": classes, "iterations": int(iters), "mesh_s": soft_s,
                         "s_per_iteration": soft_s / max(int(iters), 1), "core_fit_s": core_s,
                         "rel_vs_core": _rel(got_c, want_c)}
    result["launches"] = read_launches()
    print(f"meshfit (b) newton: {json.dumps(result)}", flush=True)
    for label, bound in (("logistic", MESH_STATS_TOL), ("squared_hinge", MESHFIT_HINGE_TOL),
                         ("softmax", 1e-4)):
        if not result[label]["rel_vs_core"] <= bound:
            raise AssertionError(f"meshfit (b) {label} off the core fit: {result[label]}")
        if not result[label].get("grad_rel_f64", 0.0) <= NEWTON_GRAD_RTOL:
            raise AssertionError(f"meshfit (b) {label}: f64 gradient at the fit {result[label]}")
    if not result["resume"]["equal_to_uninterrupted"]:
        raise AssertionError(f"meshfit (b): the resumed run differs: {result['resume']}")
    if result["launches"] != expected_launches():
        raise AssertionError(f"meshfit (b) launched a Gram kernel: {result['launches']}")
    return result


def phase_meshfit_kmeans(device: torch.device, *, rows: int = MESHFIT_KMEANS_ROWS,
                         n: int = CONFIG5_N, k: int = CONFIG5_K, iters: int = MESHFIT_LLOYD_ITERS,
                         shards: int = MESH_SHARDS, partitions: int = LINEAR_PARTITIONS,
                         seed: int = CONFIG5_SEED) -> dict:
    """Phase 22 (c): config 5's blobs (``rows`` of them) in four shards of
    the card: one k-means‖ round of the mesh program (its ownership counts
    against f64 labels but for near ties, their total exact), the weighted
    k-means++ over its candidates, then ``iters`` Lloyd iterations, each
    iteration's mesh statistics against the one-device ``kmeans_stats``
    from the same centres and against an f64 pass (phase 12's near-tie
    rule); the chunked Lloyd run killed after one chunk and resumed,
    bit-equal."""
    mesh = MM.create_mesh(data=shards, devices=[device] * shards)
    centres = kmeans_centres(k, n, device, seed)
    edges = partition_edges(rows, partitions)
    xd = torch.cat([kmeans_partition(p, edges, centres, seed) for p in range(partitions)])
    del centres
    ones = torch.ones(rows, device=device)
    block = block_rows_for(device, KM.DEFAULT_BLOCK_ROWS, k)
    gate_parts = [(xd[a:b], None, int(b - a)) for a, b in zip(edges[:-1], edges[1:])]
    result = {"rows": rows, "n": n, "k": k, "shards": shards}
    reset_launches()
    init = MPK.make_distributed_kmeans_parallel_init(mesh, k, init_steps=1)
    _sync(device)
    t0 = time.perf_counter()
    cand, counts = init(xd, ones, seed)
    _sync(device)
    init_s = time.perf_counter() - t0
    valid = counts > 0
    f64 = kmeans_f64_pass(gate_parts, cand[valid], block)
    got = torch.round(counts[valid]).long().cpu()
    result["init"] = {
        "init_s": init_s, "candidates": int(cand.shape[0]), "owning_candidates": int(valid.sum()),
        "count_total": float(counts.sum()),
        "counts_l1_vs_f64_labels": int((got - f64["counts_f64_labels"].cpu()).abs().sum()),
        "near_ties": f64["near_ties"],
    }
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    centers = KM.weighted_kmeans_plus_plus_init(gen, cand, counts, k)
    start = centers.clone()
    result["lloyd"] = []
    for it in range(iters):
        _sync(device)
        t0 = time.perf_counter()
        stats = MPK.sharded_kmeans_stats(xd, centers, mesh, weights=ones, block_rows=block)
        _sync(device)
        step_s = time.perf_counter() - t0
        one = KM.kmeans_stats(xd, centers, ones, block_rows=block)
        entry = {"mesh_stats_s": step_s,
                 "counts_l1_vs_one_device": int((stats.counts - one.counts).abs().sum()),
                 "sums_rel_vs_one_device": _rel(stats.sums, one.sums),
                 "cost_rel_vs_one_device": _rel(stats.cost, one.cost)}
        entry.update(_kmeans_gate(f"meshfit (c) Lloyd {it}", {
            "counts": stats.counts.cpu().numpy(), "cost": float(stats.cost),
            "sums": stats.sums.cpu().numpy()}, kmeans_f64_pass(gate_parts, centers, block)))
        result["lloyd"].append(entry)
        centers = KM.update_centers(stats, centers)
    fit = MPK.make_distributed_kmeans_fit(mesh, max_iter=iters, tol=0.0, block_rows=block)
    _sync(device)
    t0 = time.perf_counter()
    c_fit, _, done = fit(xd, ones, start)
    _sync(device)
    result["fit_s"] = time.perf_counter() - t0
    result["fit_equals_the_stepwise_loop"] = bool(torch.equal(c_fit, centers)) and done <= iters
    chunk = MPK.make_distributed_kmeans_chunk(mesh, chunk_iters=MESHFIT_CHUNK_ITERS, tol=0.0,
                                              block_rows=block)
    result["resume"] = _chunked_resume(MPK.run_chunked_lloyd, chunk, (xd, ones), start,
                                       max_iter=iters, tol=0.0, key="centers")
    result["launches"] = read_launches()
    print(f"meshfit (c) kmeans: {json.dumps(result)}", flush=True)
    ini = result["init"]
    if ini["count_total"] != rows or ini["counts_l1_vs_f64_labels"] > 2 * ini["near_ties"]:
        raise AssertionError(f"meshfit (c): the k-means‖ counts are off: {ini}")
    for entry in result["lloyd"]:
        if entry["counts_l1_vs_one_device"] > 2 * entry["near_ties"] or not (
                entry["sums_rel_vs_one_device"] <= KMEANS_RTOL
                and entry["cost_rel_vs_one_device"] <= KMEANS_RTOL):
            raise AssertionError(f"meshfit (c): a Lloyd step off the one-device one: {entry}")
    if not (result["fit_equals_the_stepwise_loop"]
            and result["resume"]["equal_to_uninterrupted"]):
        raise AssertionError(f"meshfit (c): the whole or resumed loop differs: {result}")
    if result["launches"] != expected_launches():
        raise AssertionError(f"meshfit (c) launched a Gram kernel: {result['launches']}")
    return result


def phase_meshfit_distance(device: torch.device, *, grids: int = MESHFIT_DBSCAN_GRIDS,
                           side: int = DBSCAN_SIDE, n: int = CONFIG5_N,
                           knn_rows: int = KNN_ROWS, knn_queries: int = MESHFIT_KNN_QUERIES,
                           k: int = KNN_K, shards: int = MESH_SHARDS, seed: int = 41) -> dict:
    """Phase 22 (d): ``make_sharded_dbscan`` over four shards of the card on
    phase 13's lattice rows (``grids`` grids), its labels equal to the
    one-device ``dbscan_labels`` exactly; ``make_sharded_knn`` on phase 13's
    corpus against the one-device ``knn_topk`` (scores rtol 1e-5) and the
    f64 top k (ids outside it only at near ties)."""
    mesh = MM.create_mesh(data=shards, devices=[device] * shards)
    x = dbscan_workload(grids, side, n, device)
    rows = len(x)
    eps_sq = float(np.float32(DBSCAN_EPS**2))
    block = block_rows_for(device, DB.DEFAULT_BLOCK_ROWS)
    xd = torch.from_numpy(x).to(device)
    ones = torch.ones(rows, device=device)
    reset_launches()
    _sync(device)
    t0 = time.perf_counter()
    labels = MPD.make_sharded_dbscan(mesh, block_rows=block)(xd, ones, ones, eps_sq,
                                                             float(DBSCAN_MIN_SAMPLES))[:rows]
    _sync(device)
    sharded_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = DB.dbscan_labels(xd, ones, ones.bool(), eps_sq, float(DBSCAN_MIN_SAMPLES),
                           block_rows=block)
    _sync(device)
    one_s = time.perf_counter() - t0
    result = {"dbscan": {"rows": rows, "sharded_s": sharded_s, "one_device_s": one_s,
                         "clusters": int(len(torch.unique(one[one >= 0]))),
                         "label_mismatches": int((labels != one).sum())}}
    del xd
    corpus, queries = knn_workload(knn_rows, knn_queries, n, device, seed)
    valid = torch.ones(knn_rows, device=device)
    _sync(device)
    t0 = time.perf_counter()
    s_mesh, i_mesh = MPN.make_sharded_knn(mesh, k)(corpus, valid, queries)
    _sync(device)
    knn_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s_one, _ = NN.knn_topk(queries, corpus, valid.bool(), k)
    _sync(device)
    one_knn_s = time.perf_counter() - t0
    d64, _ = knn_f64(queries, corpus, k)
    gate = knn_f64_gate(queries, corpus, i_mesh.cpu().numpy(),
                        np.sqrt(np.maximum(-s_mesh.cpu().numpy(), 0.0)), d64, k)
    result["knn"] = {"corpus_rows": knn_rows, "queries": knn_queries, "k": k,
                     "sharded_s": knn_s, "one_device_s": one_knn_s,
                     "scores_rel_vs_one_device": float(((s_mesh - s_one).abs()
                                                        / s_one.abs().clamp(min=1e-30)).max()),
                     **gate}
    result["launches"] = read_launches()
    print(f"meshfit (d) dbscan and knn: {json.dumps(result)}", flush=True)
    if result["dbscan"]["label_mismatches"] or result["dbscan"]["clusters"] < grids:
        raise AssertionError(f"meshfit (d): sharded DBSCAN labels: {result['dbscan']}")
    kn = result["knn"]
    if kn["ids_outside_f64_top_k"] or not (kn["max_rel_dist_err"] <= KNN_RTOL
                                           and kn["scores_rel_vs_one_device"] <= KNN_RTOL):
        raise AssertionError(f"meshfit (d): sharded kNN: {kn}")
    if result["launches"] != expected_launches():
        raise AssertionError(f"meshfit (d) launched a Gram kernel: {result['launches']}")
    return result


def phase_meshfit_trees_nb(higgs: tuple, device: torch.device, *,
                           rows: int = MESHFIT_FOREST_ROWS, trees: int = MESHFIT_FOREST_TREES,
                           nb_rows: int = MESHFIT_NB_ROWS, nb_n: int = NB_N,
                           classes: int = NB_CLASSES, shards: int = MESH_SHARDS,
                           seed: int = HIGGS_SEED) -> dict:
    """Phase 22 (e): a RandomForestClassifier (Spark's depth, bins and
    feature subsets) built on the first ``rows`` HIGGS-shaped rows through
    the mesh-sharded builder (``_mesh_forest_builder`` over four shards of
    the card) and through the one-device build: equal field for field
    (unit weights and Poisson counts: integer histogram sums); then
    ``sharded_nb_stats`` and ``sharded_nb_centered_sq`` on ``nb_rows`` of
    phase 16's count rows against the one-device passes (1e-5 × max)."""
    x, y_cls = higgs[0][:rows], higgs[1][:rows]
    mesh = MM.create_mesh(data=shards, devices=[device] * shards)
    est = RandomForestClassifier(device=device, numTrees=trees, maxDepth=FOREST_DEPTH,
                                 maxBins=FOREST_BINS, seed=seed)
    builder = spark_est._mesh_forest_builder(device)
    real_mesh = spark_est._driver_mesh
    spark_est._driver_mesh = lambda _device: mesh
    reset_launches()
    try:
        _sync(device)
        t0 = time.perf_counter()
        sharded, _ = est._fit_arrays(x, y_cls, None, builder=builder)
        _sync(device)
        sharded_s = time.perf_counter() - t0
    finally:
        spark_est._driver_mesh = real_mesh
    t0 = time.perf_counter()
    one, _ = est._fit_arrays(x, y_cls, None)
    _sync(device)
    one_s = time.perf_counter() - t0
    differing = [f for f in FO.TreeArrays._fields
                 if not np.array_equal(getattr(sharded, f), getattr(one, f))]
    result = {"forest": {"rows": rows, "trees": trees, "depth": FOREST_DEPTH,
                         "sharded_s": sharded_s, "one_device_s": one_s,
                         "split_nodes": int((~one.is_leaf).sum()),
                         "differing_fields": differing}}
    counts, labels = nb_count_workload(nb_rows, nb_n, classes, device, seed)
    cd = torch.from_numpy(counts).to(device)
    ld = torch.from_numpy(labels).float().to(device)
    ones = torch.ones(nb_rows, device=device)
    _sync(device)
    t0 = time.perf_counter()
    stats = MPNB.sharded_nb_stats(cd, ld, ones, classes, mesh)
    mu = stats.feat_sum / stats.counts.clamp(min=1.0)[:, None]
    sq = MPNB.sharded_nb_centered_sq(cd, ld, ones, mu, classes, mesh)
    _sync(device)
    nb_s = time.perf_counter() - t0
    one_stats = NBO.nb_stats(cd, ld, ones, classes)
    one_sq = NBO.nb_centered_sq(cd, ld, ones, mu, classes)
    result["naive_bayes"] = {
        "rows": nb_rows, "n": nb_n, "classes": classes, "sharded_s": nb_s,
        "counts_exact": bool(torch.equal(stats.counts, one_stats.counts)),
        "feat_sum_rel_vs_one_device": _rel(stats.feat_sum, one_stats.feat_sum),
        "centered_sq_rel_vs_one_device": _rel(sq, one_sq),
    }
    result["launches"] = read_launches()
    print(f"meshfit (e) trees and naive bayes: {json.dumps(result)}", flush=True)
    if differing or not result["forest"]["split_nodes"]:
        raise AssertionError(f"meshfit (e): the sharded forest differs: {result['forest']}")
    nb = result["naive_bayes"]
    if not (nb["counts_exact"] and nb["feat_sum_rel_vs_one_device"] <= NB_RTOL
            and nb["centered_sq_rel_vs_one_device"] <= NB_RTOL):
        raise AssertionError(f"meshfit (e): the sharded NaiveBayes statistics: {nb}")
    if result["launches"] != expected_launches():
        raise AssertionError(f"meshfit (e) launched a Gram kernel: {result['launches']}")
    return result


def phase_meshfit_ann(device: torch.device, *, rows: int = MESHFIT_ANN_ROWS,
                      chunk: int = ANN_STREAM_CHUNK, n: int = CONFIG5_N,
                      clusters: int = ANN_STREAM_CLUSTERS, shards: int = MESH_SHARDS,
                      seed: int = ANN_SEED) -> dict:
    """Phase 22 (f): one streamed Lloyd pass of the IVF index over
    ``ann_stream_workload``'s chunks through the mesh-sharded fold
    (``_lloyd_mesh_fold``, four shards of the card, one allreduce) and
    through the one-device fold, from the same √rows centres: the counts
    equal but for f64 near ties (twice their number), the centres of every
    cell whose count agrees within 1e-5 × max, the cost rtol 1e-5; then
    the index's ``_lloyd`` over the mesh for 2 passes, timed."""
    from spark_rapids_ml_tpu_torch.ann import index as AI

    chunks, _ = ann_stream_workload(rows, chunk, n, clusters, 1, device, seed)
    nlist = int(np.sqrt(rows))
    centers = chunks[0][np.random.default_rng(seed).choice(len(chunks[0]), nlist, replace=False)]
    mesh = MM.create_mesh(data=shards, devices=[device] * shards)
    old = torch.from_numpy(centers).to(device)
    reset_launches()

    def one_pass(fold, init, **kw):
        _sync(device)
        t0 = time.perf_counter()
        res = ingest.stream_fold(iter(chunks), fold, n=n, init=init, device=device, **kw)
        _sync(device)
        return res.carry, time.perf_counter() - t0

    carry, mesh_s = one_pass(AI._lloyd_mesh_fold(mesh), lambda: AI._init_mesh_carry(centers, mesh),
                             chunk_rows=MG.stream_chunk_rows_for_mesh(mesh),
                             put_fn=MG.chunk_put(mesh), min_chunk_rows=shards)
    got = MG.finalize_chunk_fold(KM.KMeansStats(carry.sums, carry.counts, carry.cost), mesh)
    z = dict(device=device, dtype=torch.float32)
    carry1, one_s = one_pass(AI._lloyd_step, lambda: AI._LloydCarry(
        torch.zeros((nlist, n), **z), torch.zeros(nlist, **z), torch.zeros((), **z), old))
    want = KM.KMeansStats(carry1.sums, carry1.counts, carry1.cost)
    f64 = kmeans_f64_pass([(torch.from_numpy(c).to(device), None, len(c)) for c in chunks], old,
                          block_rows_for(device, KM.DEFAULT_BLOCK_ROWS, nlist))
    same = got.counts == want.counts
    new_got, new_want = KM.update_centers(got, old), KM.update_centers(want, old)
    result = {
        "rows": rows, "n": n, "nlist": nlist, "shards": shards, "mesh_pass_s": mesh_s,
        "one_device_pass_s": one_s, "near_ties": f64["near_ties"],
        "counts_l1_vs_one_device": int((got.counts - want.counts).abs().sum()),
        "cells_differing": int((~same).sum()),
        "centers_rel_vs_one_device": _rel(new_got[same], new_want[same]),
        "cost_rel_vs_one_device": _rel(got.cost, want.cost),
    }
    est = AI.IVFFlatIndex(device=device, maxIter=2, seed=seed)
    est._mesh_or_none = lambda: mesh
    _sync(device)
    t0 = time.perf_counter()
    est._lloyd(lambda: iter(chunks), centers, n, chunks[0][:4096])
    _sync(device)
    result["lloyd_two_passes_s"] = time.perf_counter() - t0
    result["launches"] = read_launches()
    print(f"meshfit (f) ann: {json.dumps(result)}", flush=True)
    if result["counts_l1_vs_one_device"] > 2 * result["near_ties"] or not (
            result["centers_rel_vs_one_device"] <= MESH_STATS_TOL
            and result["cost_rel_vs_one_device"] <= MESH_STATS_TOL):
        raise AssertionError(f"meshfit (f): the mesh Lloyd fold off one device: {result}")
    if result["launches"] != expected_launches():
        raise AssertionError(f"meshfit (f) launched a Gram kernel: {result['launches']}")
    return result


def _meshfit_barrier_rank(rank: int, size: int, port: int, path: str, frames: int,
                          device_type: str, q) -> None:
    """One rank of phase 22 (g), in a spawned process: its frames through the
    LinearRegression, binary and softmax Newton and KMeans barrier bodies
    in turn; its rows, or its error, go to ``q``."""
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        data = np.load(path, mmap_mode="r")
        edges = partition_edges(len(data["x"]), frames)
        per = frames // size
        batches = [ColumnFrame({name: np.ascontiguousarray(data[name][edges[f]:edges[f + 1]])
                                for name in data.files if name != "c0"})
                   for f in range(rank * per, (rank + 1) * per)]
        ctx = StoreBarrierContext(rank, size, port)
        reg = dict(reg_param=MESHFIT_NEWTON_REG, fit_intercept=True,
                   max_iter=MESHFIT_NEWTON_ITER, tol=1e-6, device=device_type)
        bodies = {
            "linreg": spmd.MeshLinRegPartitionFn("x", "y", "w", device=device_type),
            "logreg": spmd.MeshLogRegFitFn("x", "yb", None, **reg),
            "softmax": spmd.MeshSoftmaxFitFn("x", "yc", None, MESHFIT_BARRIER_CLASSES,
                                             **{**reg, "max_iter": MESHFIT_BARRIER_SOFTMAX_ITER}),
            "kmeans": spmd.MeshKMeansFitFn("blobs", np.asarray(data["c0"]), None, max_iter=10,
                                           tol=0.0, device=device_type),
        }
        reset_launches()
        rows_out = {name: fn.mesh_arrays(batches, ctx) for name, fn in bodies.items()}
        q.put((rank, rows_out, read_launches(), None))
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        import traceback

        q.put((rank, None, None, traceback.format_exc()))


def phase_meshfit_barrier(x_host: np.ndarray, linreg: dict, device: torch.device, *,
                          rows: int = MESHFIT_BARRIER_ROWS, ranks: int = MESH_BARRIER_RANKS,
                          frames: int = MESH_BARRIER_FRAMES, seed: int = LINEAR_SEED) -> dict:
    """Phase 22 (g): ``MeshLinRegPartitionFn``, ``MeshLogRegFitFn``,
    ``MeshSoftmaxFitFn`` (3 classes) and ``MeshKMeansFitFn`` in one spawn of
    ``ranks`` processes on one device over gloo, each rank running the four
    bodies in turn on its frames of the first ``rows`` of phase 8's rows
    (phase 14's labels and weights; logistic and softmax labels; config
    5-style blobs for KMeans). Only rank 0 yields; each row against the
    in-process mesh program over the same rows (1e-5 × max; class-centred
    for softmax) and f64: the statistics through phase 14's bound, the
    Newton fits' f64 gradient, the KMeans cost."""
    import datetime
    import multiprocessing as mp

    n = x_host.shape[1]
    x = x_host[:rows]
    xd = torch.from_numpy(x).to(device)
    yb = _logistic_labels(xd, seed)
    yc = _softmax_labels(xd, MESHFIT_BARRIER_CLASSES, seed)
    k = MESHFIT_BARRIER_K
    centres = kmeans_centres(k, CONFIG5_N, device, CONFIG5_SEED)
    edges = partition_edges(rows, frames)
    blobs = torch.cat([kmeans_partition(p, edges, centres, CONFIG5_SEED) for p in range(frames)])
    c0 = blobs[torch.randperm(rows, generator=torch.Generator().manual_seed(seed))[:k].to(
        device)].cpu().numpy()
    data = {"x": x, "y": linreg["y"][:rows], "w": linreg["w"][:rows].astype(np.float32),
            "yb": yb.astype(np.float32), "yc": yc.astype(np.float32),
            "blobs": blobs.cpu().numpy(), "c0": c0}
    store = torch.distributed.TCPStore("127.0.0.1", 0, ranks + 1, True,
                                       timeout=datetime.timedelta(seconds=300),
                                       wait_for_workers=False)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-meshfit-") as tmp:
        path = os.path.join(tmp, "rows.npz")
        np.savez(path, **data)
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_meshfit_barrier_rank,
                             args=(r, ranks, store.port, path, frames, device.type, q))
                 for r in range(ranks)]
        for p in procs:
            p.start()
        try:
            results = sorted((q.get(timeout=600) for _ in procs), key=lambda t: t[0])
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
        stage_s = time.perf_counter() - t0
    errors = [err for *_, err in results if err]
    if errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"meshfit (g): a rank failed: {errors or [p.exitcode for p in procs]}")
    yielded = {name: [r for r, out, _, _ in results if out[name] is not None]
               for name in results[0][1]}
    row = results[0][1]
    launches = {name: sum(r[2][name] for r in results) for name in KERNELS}
    mesh = MM.create_mesh(data=ranks, devices=[device] * ranks)
    wd = torch.from_numpy(data["w"]).to(device)
    ones = torch.ones(rows, device=device)
    xa = torch.cat([xd, ones[:, None]], 1)
    result = {"rows": rows, "n": n, "ranks": ranks, "frames": frames, "stage_s": stage_s,
              "yielding_ranks": yielded, "launches": launches}
    # LinearRegression: the statistics
    lin = MPL.sharded_linear_stats_weighted(xd, torch.from_numpy(data["y"]).to(device), wd, mesh)
    got = LIN.LinearStats(*(torch.as_tensor(np.asarray(row["linreg"][f]), device=device)
                            for f in LIN.LinearStats._fields))
    oracle = linear_stats_f64(x, data["y"], linreg["w"][:rows], device)[1]
    coef, b0 = LIN.solve_from_stats(got)
    result["linreg"] = {"rel_vs_in_process": _stats_rel(got, lin),
                        "gates_vs_f64": linreg_gates(got, oracle, coef.cpu().numpy(), float(b0),
                                                     stats_rtol=None)}
    # the Newton fits: parameters, and the f64 gradient at them
    for name, labels, classes in (("logreg", yb, None), ("softmax", yc, MESHFIT_BARRIER_CLASSES)):
        yd = torch.from_numpy(labels.astype(np.float32)).to(device)
        if classes is None:
            fit = MPL.make_distributed_logreg_fit(mesh, reg_param=MESHFIT_NEWTON_REG,
                                                  max_iter=MESHFIT_NEWTON_ITER, tol=1e-6)
        else:
            fit = MPL.make_distributed_softmax_fit(mesh, classes, reg_param=MESHFIT_NEWTON_REG,
                                                   max_iter=MESHFIT_BARRIER_SOFTMAX_ITER, tol=1e-6)
        w_in, _, _ = fit(xa, yd, ones)
        w_row = np.asarray(row[name]["w"], np.float64)
        rel = (_rel(w_row, w_in) if classes is None else
               _rel(_centred_classes(w_row, classes), _centred_classes(w_in.cpu().numpy(), classes)))
        y64 = torch.from_numpy(labels).to(device)
        wt = torch.from_numpy(w_row).to(device)
        _, grad, _ = newton_f64(xd, y64, wt, MESHFIT_NEWTON_REG, classes, hessian=False)
        _, grad0, _ = newton_f64(xd, y64, torch.zeros_like(wt), MESHFIT_NEWTON_REG, classes,
                                 hessian=False)
        result[name] = {"iterations": float(row[name]["iterations"]), "rel_vs_in_process": rel,
                        "grad_rel_f64": float(torch.linalg.norm(grad) / torch.linalg.norm(grad0))}
    # KMeans: the centres, and the f64 cost at them
    c_in, _, _ = MPK.make_distributed_kmeans_fit(mesh, max_iter=10, tol=0.0)(
        blobs, ones, torch.from_numpy(c0).to(device))
    c_row = np.asarray(row["kmeans"]["centers"], np.float32)
    f64 = kmeans_f64_pass([(blobs, None, rows)], torch.from_numpy(c_row).to(device),
                          block_rows_for(device, KM.DEFAULT_BLOCK_ROWS, k), compare=False)
    result["kmeans"] = {"rel_vs_in_process": _rel(c_row, c_in),
                        "cost_rel_f64": abs(float(row["kmeans"]["cost"]) - f64["cost64"])
                        / f64["cost64"]}
    print(f"meshfit (g) barrier: {json.dumps(result)}", flush=True)
    if any(v != [0] for v in yielded.values()):
        raise AssertionError(f"meshfit (g): ranks {yielded} yielded rows, expected rank 0 alone")
    if launches != expected_launches():
        raise AssertionError(f"meshfit (g): the ranks launched {launches}")
    for name in ("linreg", "logreg", "softmax", "kmeans"):
        if not result[name]["rel_vs_in_process"] <= MESH_STATS_TOL:
            raise AssertionError(f"meshfit (g): the {name} row off the in-process program: "
                                 f"{result[name]}")
    for name in ("logreg", "softmax"):
        if not result[name]["grad_rel_f64"] <= NEWTON_GRAD_RTOL:
            raise AssertionError(f"meshfit (g): the {name} row's f64 gradient: {result[name]}")
    if not result["kmeans"]["cost_rel_f64"] <= KMEANS_RTOL:
        raise AssertionError(f"meshfit (g): the KMeans row's cost off f64: {result['kmeans']}")
    return result


def _meshfit_launches(meshfit: dict, name: str) -> dict:
    """One kernel's launches in each part of phase 22 that ran."""
    out = {}
    for part, result in meshfit.items():
        launches = result["launches"]
        if name in launches:
            out[part] = launches[name]
        else:  # (a): one count per program
            out.update({f"{part}_{prog}": counts[name] for prog, counts in launches.items()})
    return out


def _timed(name: str, fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# Groups of later phases that a run may leave out (``--skip serving,ann``);
# every phase runs by default. None feeds the kernels line, and each group's
# phases need only what its own group makes.
SKIPPABLE = {
    "serving": "phases 10 and 11 (config 4 pipelines, serving)",
    "config5": "phase 12 (config 5 KMeans)",
    "distance": "phase 13 (DBSCAN, exact kNN)",
    "ann": "phase 15 (ANN resident, serving, streamed)",
    "trees": "phases 16 and 17 (trees, NaiveBayes, the families)",
    "selection": "phase 18 (a), (b), (e) (model selection, the device policy)",
    "spark": "phase 20 (the Spark glue's bodies and driver halves)",
    "mesh": "phase 21 (the device mesh, its programs and the barrier bodies)",
    "meshfit": "phase 22 (the mesh fits: linear, Newton, KMeans, DBSCAN, kNN, forest, "
               "NaiveBayes, ANN, the fit barrier bodies)",
}


def parse_skip(argv) -> set[str]:
    """The groups ``--skip a,b`` names (none by default)."""
    import argparse

    parser = argparse.ArgumentParser(description="Drive the port's main paths on one card.")
    parser.add_argument("--skip", default="", help="comma-separated groups to leave out: "
                        + "; ".join(f"{k}: {v}" for k, v in SKIPPABLE.items()))
    skip = {g for g in parser.parse_args(list(argv)).skip.split(",") if g}
    unknown = skip - set(SKIPPABLE)
    if unknown:
        parser.error(f"unknown groups {sorted(unknown)}; choose from {sorted(SKIPPABLE)}")
    return skip


def main(argv=()) -> int:
    skip = parse_skip(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs only on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device = torch.device("cuda", 0)

    card = _timed("card", phase_card)
    build = _timed("build", phase_build)
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    schedules = {}
    for name in KERNELS:
        rows, n = KERNEL_SHAPES[name][0]
        schedules[name] = schedule_summary(rows, n, name in SYMMETRIC, sm_count)
        print(f"schedule: {name}: {json.dumps(schedules[name])}", flush=True)
    checks, timings = {}, {}
    for name in KERNELS:
        checks[name] = _timed(f"check {name}", phase_kernel_check,
                              KERNEL_SHAPES[name], device, kernel=name)
        routes = {entry["route"] for entry in checks[name].values()}
        if routes != {"tma", "plain"}:
            raise AssertionError(f"{name}'s checks took the load routes {routes}, not both")
        timings[name] = _timed(f"timing {name}", phase_kernel_timing,
                               KERNEL_SHAPES[name], device, kernel=name)
    resident = _timed("main path (resident)", phase_main_path,
                      MAIN_ROWS, MAIN_N, MAIN_K, MAIN_PARTITIONS, device)
    costed = _timed("cost model (a)", phase_cost_model,
                    MAIN_ROWS, MAIN_N, MAIN_K, MAIN_PARTITIONS, device)
    bodies = _timed("partition bodies (c)", phase_partition_bodies,
                    MAIN_ROWS, MAIN_N, MAIN_K, MAIN_PARTITIONS, device,
                    costed.pop("model"), costed.pop("out"))
    spark_c = None
    if "spark" not in skip:
        spark_c = _timed("spark glue (c, d)", phase_spark_features,
                         MAIN_ROWS, MAIN_N, MAIN_K, MAIN_PARTITIONS, device)
    _timed("solvers", phase_solvers, MAIN_ROWS, MAIN_N, MAIN_K, MAIN_PARTITIONS, device)
    one_pass = _timed("one pass (resident)", phase_one_pass,
                      MAIN_ROWS, MAIN_N, MAIN_K, MAIN_PARTITIONS, device)
    standardized = _timed("standardize", phase_standardize,
                          MAIN_ROWS, MAIN_N, MAIN_K, MAIN_PARTITIONS, device)
    _timed("linear (d) spectral and incremental", phase_spectral_incremental,
           MAIN_ROWS, MAIN_N, MAIN_K, MAIN_PARTITIONS, device)
    _timed("recovery (d) resident", phase_recovery_resident,
           MAIN_ROWS, MAIN_N, MAIN_K, MAIN_PARTITIONS, device)
    bench_workload.cache_clear()
    stream_data = _timed("make streamed data", streamed_workload,
                         STREAM_ROWS, MAIN_N, STREAM_PARTITIONS, device)
    streamed = _timed("main path (streamed)", phase_streamed_path,
                      STREAM_ROWS, MAIN_N, MAIN_K, STREAM_PARTITIONS, device, stream_data)
    streamed_one_pass = _timed("one pass (streamed)", phase_streamed_one_pass,
                               stream_data, MAIN_K, STREAM_PARTITIONS, device)
    _timed("streamed scaler", phase_streamed_scaler, stream_data, STREAM_PARTITIONS, device)
    linreg = _timed("linear (a) streamed linreg", phase_streamed_linreg,
                    stream_data, STREAM_PARTITIONS, device)
    _timed("linear (e) serving", phase_linear_serving, linreg["model"],
           stream_data[0][:SERVE_POOL_ROWS], device)
    _timed("linear (b, c) newton", phase_newton_fits, stream_data[0], device)
    if "spark" not in skip:
        _timed("spark glue (a, d)", phase_spark_linear, stream_data[0], device)
    _timed("recovery (c) streamed", phase_recovery_streamed, stream_data, device)
    tuned = _timed("autotune (b)", phase_autotune, stream_data, MAIN_K, STREAM_PARTITIONS,
                   device)
    mesh = None
    if "mesh" not in skip:
        t_mesh = time.perf_counter()
        mesh_x, mesh_gram = streamed_workload(MESH_ROWS, MAIN_N, MESH_SHARDS, device,
                                              seed=MESH_SEED)
        mesh = {
            "inprocess": _timed("mesh (a) in-process", phase_mesh_inprocess, mesh_x, mesh_gram,
                                MAIN_K, device),
            "streamed": _timed("mesh (b) streamed", phase_mesh_streamed, stream_data, MAIN_K,
                               device, phase8_fit_s=streamed["fit_s"]),
            "tsqr_sketch": _timed("mesh (c) tsqr and sketched", phase_mesh_tsqr_sketch,
                                  mesh_x[:MESH_TSQR_ROWS], MAIN_K, device),
            "barrier": _timed("mesh (d) barrier", phase_mesh_barrier,
                              bench_workload(MAIN_ROWS, MAIN_N), MAIN_K, device),
        }
        del mesh_x, mesh_gram
        torch.cuda.empty_cache()
        print(f"phase mesh (21): {time.perf_counter() - t_mesh:.1f} s", flush=True)
    meshfit, meshfit_s = {}, []

    def run_meshfit(part: str, label: str, fn, *args):
        t0 = time.perf_counter()
        meshfit[part] = _timed(f"meshfit {label}", fn, *args)
        meshfit_s.append(time.perf_counter() - t0)
        torch.cuda.empty_cache()

    if "meshfit" not in skip:
        run_meshfit("linear", "(a) linear", phase_meshfit_linear, stream_data[0], linreg, device)
        run_meshfit("newton", "(b) newton", phase_meshfit_newton, stream_data[0], device)
        run_meshfit("barrier", "(g) barrier", phase_meshfit_barrier, stream_data[0], linreg,
                    device)
    del stream_data, linreg
    torch.cuda.empty_cache()
    if "serving" not in skip:
        config4 = _timed("config 4 pipelines", phase_pipeline,
                         MAIN_ROWS, MAIN_N, MAIN_K, MAIN_PARTITIONS, device, standardized)
        _timed("serving", phase_serving, resident["model"], standardized["model"], device,
               scaler_model=config4["scaler"]["model"].stages[0],
               report_fit_ids=tuple(r["fit_id"] for r in config4.values()))
    bench_workload.cache_clear()
    torch.cuda.empty_cache()
    if "config5" not in skip:
        _timed("config 5 kmeans", phase_config5,
               CONFIG5_ROWS, CONFIG5_N, CONFIG5_K, CONFIG5_PARTITIONS, device)
    if "spark" not in skip:
        _timed("spark glue (b, d)", phase_spark_kmeans, device)
        torch.cuda.empty_cache()
    if "meshfit" not in skip:
        run_meshfit("kmeans", "(c) kmeans", phase_meshfit_kmeans, device)
    if "distance" not in skip:
        _timed("dbscan and knn", phase_distance_family, device)
    if "meshfit" not in skip:
        run_meshfit("distance", "(d) dbscan and knn", phase_meshfit_distance, device)
    if "ann" not in skip:
        ann = _timed("ann (a) resident", phase_ann_resident, device)
        _timed("ann (c) serving", phase_ann_serving, ann.pop("model"), ann.pop("queries_h"),
               device)
        torch.cuda.empty_cache()
        _timed("ann (b) streamed", phase_ann_streamed, device)
        torch.cuda.empty_cache()
    if "meshfit" not in skip:
        run_meshfit("ann", "(f) ann", phase_meshfit_ann, device)
    if "trees" not in skip:
        higgs = _timed("make higgs data", higgs_workload, HIGGS_ROWS, HIGGS_N, device)
        _timed("trees and naive bayes", phase_trees_nb, device, data=higgs)
        torch.cuda.empty_cache()
        if "meshfit" not in skip:
            run_meshfit("trees_nb", "(e) trees and naive bayes", phase_meshfit_trees_nb, higgs,
                        device)
        _timed("families", phase_families, device, higgs)
        del higgs
        torch.cuda.empty_cache()
    if "selection" not in skip:
        _timed("selection (a) text", phase_text_selection, device)
        _timed("selection (b) tabular", phase_adult_selection, device)
        _timed("device policy (e)", phase_device_policy, device)
    if meshfit_s:
        print(f"phase meshfit (22): {sum(meshfit_s):.1f} s", flush=True)
    for group in sorted(skip):
        print(f"skipped: {SKIPPABLE[group]}", flush=True)
    # each kernel's launches come from the main path that runs it
    launches = {
        "gram_moments": resident["launches"]["gram_moments"],
        "symmetric_gram_moments": streamed["launches"]["symmetric_gram_moments"],
        "gram_moments_1pass": one_pass["launches"]["gram_moments_1pass"],
        "symmetric_gram_moments_1pass":
            streamed_one_pass["launches"]["symmetric_gram_moments_1pass"],
    }

    kernels = []
    for name, meta in KERNELS.items():
        shapes = KERNEL_SHAPES[name]
        at_main = {**checks[name][shapes[0]], **timings[name][shapes[0]]}
        kernels.append({
            "name": name,
            **meta,
            "launches": launches[name],
            # phase 19's runs of the kernel: (a) the costed fit, (c) the
            # partition bodies, (b) the searched fit (its trials included)
            # and the cached one
            "phase19_launches": {
                "cost_model_fit": costed["launches"][name],
                "partition_bodies": bodies["launches"][name],
                "autotune_search_fit": tuned["search_launches"][name],
                "autotune_cache_fit": tuned["cache_launches"][name],
            },
            # phase 20 (c): SparkTruncatedSVD's driver-merge body at "high"
            "phase20_launches": {
                "truncated_svd_driver_merge":
                    None if spark_c is None else spark_c["tsvd"]["launches"][name],
            },
            # phase 21: (a) sharded_gram_stats over four shards, (b) the
            # chunk fold on the card's own mesh and on four shards of it,
            # (d) the barrier Gram body's four ranks
            "phase21_launches": None if mesh is None else {
                "sharded_gram_stats": mesh["inprocess"]["launches"][name],
                "sharded_gram_fold_own_mesh": mesh["streamed"]["own_mesh"]["launches"][name],
                "sharded_gram_fold_four_shards":
                    mesh["streamed"]["four_shards"]["launches"][name],
                "barrier_gram_ranks": mesh["barrier"]["launches"][name],
            },
            # phase 22: each part's runs (cuBLAS products, gathers and
            # index_add_ only, so 0 unless a part launches the kernel)
            "phase22_launches": _meshfit_launches(meshfit, name) if meshfit else None,
            "max_abs_err": at_main["max_abs_err"],
            "tol": at_main["tol"],
            "ms": at_main["kernel_ms"],
            "kernel_ms": at_main["kernel_ms"],
            "plain_ms": at_main["plain_ms"],
            "bound_ms": at_main["bound_ms"],
            "bound_by": at_main["bound_by"],
            "library_ms": at_main["library_ms"],
            "hgmma": build[name]["hgmma"],
            "ptxas": build[name]["ptxas"],
            "schedule": schedules[name],
            "shapes": [{**checks[name][s], **timings[name][s]} for s in shapes],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["kind"], "count": card["count"],
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
