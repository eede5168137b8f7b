#!/usr/bin/env python3
"""Single-query / small-batch latency benchmark.

The reference is a per-query CPU library; its QPS numbers are
per-query latency numbers (reference: tinyknn/ivf.py:106 takes one
query). This measures the GPU build's latency story at GloVe scale:

  * per-call wall time (dispatch + query + (Q, k) readback) — what an
    online serving caller sees per request, floored by the host's
    dispatch and transfer cost.
  * in-jit time (marginal over a lax.map stream of batches) — the
    device-compute component alone, i.e. the latency floor once
    requests are pipelined.

Both 'gather' (per-query list gather; the shape of the reference's
per-query loop) and 'bucket' (cluster-bucketed shared scan) modes are
timed, which is the measurement behind IVF.query's mode='auto'
threshold.

Usage: python examples/latency.py [--batch 1 32] [--probes 10]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from tinyknn_tpu import utils                     # noqa: E402
from tinyknn_tpu.io import load_ivf               # noqa: E402

parser = argparse.ArgumentParser()
parser.add_argument("--batch", type=int, nargs="+", default=[1, 32])
parser.add_argument("--probes", type=int, default=10)
parser.add_argument("--k", type=int, default=10)
parser.add_argument("--calls", type=int, default=30)
parser.add_argument("--stream-reps", type=int, nargs=2, default=[16, 48])
parser.add_argument("--index", default="ivf_clustered-1183514-100_"
                    "angular_num_clusters=1087_dims_per_block=2_"
                    "build_probes=1.npz")
parser.add_argument("--scan-impl", default=None,
                    choices=["auto", "fused", "xla", "exact"])
args = parser.parse_args()

utils.enable_compilation_cache()

print("loading index...", flush=True)
ivf = load_ivf(args.index)
if args.scan_impl is not None:
    ivf.set_scan_impl(args.scan_impl)

size, dim = 1183514, 100
rng = np.random.default_rng(10)
n_comp = int((size + 10000) ** 0.5)
centers = rng.standard_normal((n_comp, dim), dtype=np.float32)
which = rng.integers(0, n_comp, 4096)
queries = (centers[which] + 0.5 * rng.standard_normal(
    (4096, dim), dtype=np.float32))

k, P = args.k, args.probes
R1, R2 = args.stream_reps

for Q in args.batch:
    for mode in ("gather", "bucket"):
        qs = queries[:Q]
        np.asarray(ivf.query(qs, k=k, n_probes=P, mode=mode))  # warm
        times = []
        for i in range(args.calls):
            q_i = queries[(i * Q) % 2048:(i * Q) % 2048 + Q]
            t0 = time.time()
            np.asarray(ivf.query(q_i, k=k, n_probes=P, mode=mode))
            times.append(time.time() - t0)
        med = float(np.median(times)) * 1000
        p90 = float(np.quantile(times, 0.9)) * 1000
        print(f"Q={Q:>3} mode={mode:>6}: per-call median {med:7.1f} ms "
              f"(p90 {p90:7.1f})  [{med/Q:7.2f} ms/query]", flush=True)
    # in-jit marginal (bucket mode: query_stream)
    qb1 = queries[None, :Q] + (np.arange(R1, dtype=np.float32)
                               [:, None, None] * 1e-6)
    qb2 = queries[None, :Q] + (np.arange(R2, dtype=np.float32)
                               [:, None, None] * 1e-6)
    np.asarray(ivf.query_stream(qb1, k=k, n_probes=P))
    np.asarray(ivf.query_stream(qb2, k=k, n_probes=P))
    t1 = t2 = float("inf")
    for _ in range(3):
        t0 = time.time()
        np.asarray(ivf.query_stream(qb1, k=k, n_probes=P))
        t1 = min(t1, time.time() - t0)
        t0 = time.time()
        np.asarray(ivf.query_stream(qb2, k=k, n_probes=P))
        t2 = min(t2, time.time() - t0)
    marg = (t2 - t1) / (R2 - R1) * 1000
    print(f"Q={Q:>3} bucket in-jit: {marg:7.1f} ms/batch "
          f"[{marg/Q:7.2f} ms/query]", flush=True)
