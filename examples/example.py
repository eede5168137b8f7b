#!/usr/bin/env python3
"""FastPQ-accelerated exact kNN demo (reference: examples/example.py).

Fits a 4-bit PQ, runs the full-scan distance estimate for a batch of
queries in one jitted sweep, and reports the rank distribution of the
true nearest neighbor plus QPS. The reference loops queries one at a
time through Cython; here the whole batch is one device dispatch.
"""

import argparse
import re
import time

import numpy as np

import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[1]))  # allow running without install

from tinyknn_tpu import FastPQ, knn_brute, utils

parser = argparse.ArgumentParser()
parser.add_argument("--input", type=str, default="random-16000-128",
                    help="Input .npy file or random-n-d")
parser.add_argument("--k", type=int, default=1000,
                    help="Number of queries")
parser.add_argument("--dpb", type=int, default=2, help="Dimensions per block")
parser.add_argument("--unsigned", action="store_true",
                    help="Use unsigned distance quantization")
parser.add_argument("--rotate-dim", type=int, default=None,
                    help="Random-rotation projection dim (default: off)")
args = parser.parse_args()

if match := re.match(r"random-(\d+)-(\d+)", args.input):
    n, d = map(int, match.groups())
    with utils.timer(True, f"Sampling {n=} vectors of dimension {d=}"):
        X = np.random.randn(n, d).astype(np.float32)
        qs = np.random.randn(args.k, d).astype(np.float32)
else:
    with utils.timer(True, f"Loading and shuffling {args.input}"):
        data = np.load(args.input).astype(np.float32)
        np.random.seed(10)
        np.random.shuffle(data)
        qs = data[:args.k]
        X = data[args.k:]
        n, d = X.shape

k, dpb, signed = args.k, args.dpb, not args.unsigned
print(f"{n=}, {d=}, queries={k}, dims_per_block={dpb}")

with utils.timer(True, "Computing true neighbours"):
    trus = np.asarray(knn_brute(qs, X, k=1))[:, 0]

with utils.timer(True, "Fitting PQ"):
    pq = FastPQ(dims_per_block=dpb, rotate_dim=args.rotate_dim)
    pq.fit(X[:10**5])

with utils.timer(True, "Transforming data"):
    data = pq.transform(X)
    utils.block(data.packed)

print("Querying (batched: one dispatch for all queries)")
# warm up / compile
dtable = pq.distance_table(qs) if signed else pq.udistance_table(qs)
est = dtable.estimate_distances(data)
utils.block(est)

start = time.time()
dtable = pq.distance_table(qs) if signed else pq.udistance_table(qs)
t1 = time.time() - start

start = time.time()
est = dtable.estimate_distances(data)
utils.block(est)
t2 = time.time() - start

import jax
import jax.numpy as jnp


@jax.jit
def _rank_stats(est, trus_j):
    tru_vals = jnp.take_along_axis(est, trus_j[:, None], axis=1)
    less = jnp.sum(est < tru_vals, axis=1)
    ties = jnp.sum(est == tru_vals, axis=1) - 1
    at_max = jnp.sum(est == jnp.max(est))
    return less + ties // 2, at_max


places, sat_up = _rank_stats(est, jnp.asarray(trus))
places = np.asarray(places)
sat_up, total = int(sat_up), est.size

print()
print("Median place of true nearest neighbor:", np.median(places))
for q in [0.5, 0.75, 0.9, 0.99]:
    print(f"{q:.2%} quantile:", np.quantile(places, q))
print("Queries/second:", k / (t1 + t2))
print()
print("Total time spent on preprocess:", t1)
print("Total time spent on search:", t2)
print(f"Values at estimate max (int32 accumulation never saturates): "
      f"{sat_up}/{total}")
