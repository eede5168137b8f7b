#!/usr/bin/env python3
"""Annoy competitor baseline for the QPS-recall plot.

Counterpart of the reference's Annoy sweep (reference:
examples/annoy.py): build Annoy forests of increasing size, sweep
search_k, and print `recall= qps=` lines that plot_bench.py can scrape
alongside the IVF sweep. Requires the `annoy` package (pure CPU — this
is the baseline the accelerator index is compared against); exits with a clear
message when it is not installed.
"""

import argparse
import os.path
import re
import sys
import time

import numpy as np

import pathlib as _pl
sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[1]))

from tinyknn_tpu import knn_brute  # noqa: E402
from tinyknn_tpu.utils import make_clustered  # noqa: E402

try:
    from annoy import AnnoyIndex
except ImportError:
    sys.exit("the `annoy` package is not installed — "
             "`pip install annoy` to run this baseline")

parser = argparse.ArgumentParser(description="Annoy baseline sweep")
parser.add_argument("filename",
                    help=".npy file, or random-<size>-<dim> / "
                         "clustered-<size>-<dim> synthetic data")
parser.add_argument("--n-queries", type=int, default=10000)
parser.add_argument("--k-neighbours", type=int, default=10)
parser.add_argument("--metric", choices=["euclidean", "angular"],
                    default="angular")
parser.add_argument("--trees", type=int, nargs="*", default=[100, 200, 400])
args = parser.parse_args()

num_queries, k_neighbours = args.n_queries, args.k_neighbours

print("Loading and shuffling...")
if match := re.match(r"(random|clustered)-(\d+)-(\d+)", args.filename):
    kind, size, dim = match.group(1), int(match.group(2)), int(match.group(3))
    if kind == "random":
        data = np.random.default_rng(10).standard_normal(
            (size + num_queries, dim), dtype=np.float32)
    else:  # ONE source of truth for the clustered recipe
        data = np.concatenate(
            make_clustered(size, dim, num_queries))
else:
    data = np.load(args.filename).astype(np.float32)
    np.random.seed(10)
    np.random.shuffle(data)
data, queries = data[:-num_queries], data[-num_queries:]
num_points, num_dims = data.shape
print(f"{num_points=}, {num_dims=}, {num_queries=}")

simple_name = os.path.basename(args.filename)
trus_file = (f"trus_{simple_name}_k_neighbours={k_neighbours}_"
             f"num_queries={num_queries}_metric='{args.metric}'.npy")
if os.path.isfile(trus_file):
    true_neighbours = np.load(trus_file)
else:
    print("Computing true neighbours (brute force)...")
    true_neighbours = np.asarray(
        knn_brute(queries, data, k_neighbours, metric=args.metric))
    np.save(trus_file, true_neighbours)
true_sets = [set(t.tolist()) for t in true_neighbours]

metric = "angular" if args.metric == "angular" else "euclidean"
for n_trees in args.trees:
    print(f"Building Annoy index with {n_trees} trees...")
    t0 = time.time()
    ann = AnnoyIndex(num_dims, metric)
    for i, v in enumerate(data):
        ann.add_item(i, v)
    ann.build(n_trees)
    print(f"build: {time.time() - t0:.1f}s")

    recall = 0.0
    search_k = 100
    while recall < 0.95 and search_k <= 400000:
        t0 = time.time()
        found = 0
        for i, q in enumerate(queries):
            guess = ann.get_nns_by_vector(q, n=k_neighbours,
                                          search_k=search_k)
            found += len(true_sets[i] & set(guess))
        elapsed = time.time() - t0
        recall = found / k_neighbours / num_queries
        qps = num_queries / elapsed
        print(f"Probing {search_k:>6}: recall{k_neighbours}@"
              f"{k_neighbours}={recall:.5f}  QPS={qps:,.2f}")
        search_k *= 2
