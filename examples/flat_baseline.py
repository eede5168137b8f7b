#!/usr/bin/env python3
"""Exact (Flat) baseline QPS for the QPS-recall plot.

Plays the role of the reference's Annoy comparison
(reference: examples/annoy.py) with the baseline that actually matters
on an accelerator: exact brute force is a single matmul + top_k, so any
approximate index must beat IT, not a CPU tree library. Recall is 1.0
by construction; this prints the QPS to draw as a vertical line.
"""

import argparse
import re
import time

import numpy as np

import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[1]))  # allow running without install

from tinyknn_tpu import Flat, knn_brute, utils

parser = argparse.ArgumentParser()
parser.add_argument("--input", type=str, default="random-100000-100")
parser.add_argument("--n-queries", type=int, default=10000)
parser.add_argument("--k", type=int, default=10)
parser.add_argument("--metric", choices=["euclidean", "angular"],
                    default="angular")
args = parser.parse_args()

if match := re.match(r"random-(\d+)-(\d+)", args.input):
    n, d = map(int, match.groups())
    rng = np.random.default_rng(10)
    X = rng.standard_normal((n, d), dtype=np.float32)
    qs = rng.standard_normal((args.n_queries, d), dtype=np.float32)
else:
    data = np.load(args.input).astype(np.float32)
    np.random.seed(10)
    np.random.shuffle(data)
    qs, X = data[:args.n_queries], data[args.n_queries:]
    n, d = X.shape

index = Flat(args.metric)
index.build(X)

with utils.timer(True, "warmup/compile..."):
    ids = np.asarray(index.query(qs, k=args.k))

start = time.time()
ids = np.asarray(index.query(qs, k=args.k))
elapsed = time.time() - start
print(f"Flat exact search over n={n}, d={d}: "
      f"{args.n_queries/elapsed:,.0f} QPS (recall 1.0)")
