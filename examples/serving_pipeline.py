#!/usr/bin/env python3
"""Pipelined serving with ``query_stream(device_out=True)``.

The reference's serving story is one query per call with ids returned
to Python (reference: tinyknn/ivf.py:106-163). On an accelerator the ids are
usually NOT the product — they feed a next stage (fetch neighbor
embeddings, pool them, score a candidate set). This example runs that
whole two-stage pipeline on device:

    stage 1: IVF top-k ids for an (R, Q, d) stream   (device_out=True)
    stage 2: gather the neighbors' stored vectors and mean-pool them
             (a kNN "read head": the (R, Q, k) ids never reach the
             host; only the final (Q, d) pooled block does)

and times it against the same pipeline with a host hop between the
stages (ids downloaded, then re-uploaded for the gather) — the shape
every per-query-loop port pays.

Run on anything: small shapes by default (CPU-friendly); pass
``--glove`` to use the cached GloVe-scale archive on the GPU.

Usage: python examples/serving_pipeline.py [--glove] [--reps 2 7]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax                                          # noqa: E402
import jax.numpy as jnp                             # noqa: E402

from tinyknn_tpu import FastPQ, IVF, utils          # noqa: E402

parser = argparse.ArgumentParser()
parser.add_argument("--glove", action="store_true",
                    help="GloVe-scale cached archive (GPU)")
parser.add_argument("--reps", type=int, nargs=2, default=[2, 7])
parser.add_argument("--k", type=int, default=10)
parser.add_argument("--n-probes", type=int, default=1)
args = parser.parse_args()

utils.enable_compilation_cache()
k, P = args.k, args.n_probes
R1, R2 = args.reps

if args.glove:
    from tinyknn_tpu.io import load_ivf
    ivf = load_ivf("ivf_clustered-1183514-100_angular_num_clusters="
                   "1087_dims_per_block=2_build_probes=1.npz")
    size, dim, nq = 1183514, 100, 10000
    corpus, queries = utils.make_clustered(size, dim, nq)
else:
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((20000, 64), dtype=np.float32)
    queries = rng.standard_normal((1024, 64), dtype=np.float32)
    ivf = IVF("angular", 64, FastPQ(2, rotate_dim=None))
    ivf.fit(corpus).build(corpus, n_probes=2)
    nq = len(queries)

# stage-2 operand: the stored vectors, placed once (any per-id side
# table works the same way — embeddings, payload features, ...)
vecs = jnp.asarray(corpus)


@jax.jit
def read_head(ids, vecs):
    """Mean-pool the k neighbors' vectors per query: (R, Q, k) ids +
    (n, d) store -> (Q, d), averaged over the stream — stands in for
    whatever consumes retrieval results on device."""
    pooled = jnp.take(vecs, ids, axis=0)            # (R, Q, k, d)
    return pooled.mean(axis=(0, 2))


qbs = {r: jnp.asarray(queries[None] + np.arange(
    r, dtype=np.float32)[:, None, None] * 1e-6) for r in (R1, R2)}


def pipelined(r):
    ids, _ = ivf.query_stream(qbs[r], k=k, n_probes=P,
                              device_out=True)      # stays on device
    out = read_head(ids, vecs)
    return float(jnp.sum(out))                      # scalar readback


def host_hop(r):
    ids = ivf.query_stream(qbs[r], k=k, n_probes=P)  # ids -> host
    out = read_head(jnp.asarray(ids), vecs)          # ids -> device
    return float(jnp.sum(out))


def marginal(fn):
    el = {}
    for r in (R1, R2):
        fn(r)                                        # warm/compile
        best = float("inf")
        for _ in range(3):
            t0 = time.time()
            fn(r)
            best = min(best, time.time() - t0)
        el[r] = best
    return (el[R2] - el[R1]) / (R2 - R1) if el[R2] > el[R1] \
        else el[R2] / R2


s_pipe = pipelined(R1)
s_host = host_hop(R1)
assert abs(s_pipe - s_host) < 1e-3 * max(1.0, abs(s_host)), (
    s_pipe, s_host)  # same ids, same pool

t_pipe = marginal(pipelined)
t_host = marginal(host_hop)
print(f"two-stage retrieval pipeline, Q={nq} k={k} P={P} "
      f"(marginal/rep, best-of-3 at R={R1},{R2}):")
print(f"  device_out pipelined : {t_pipe * 1e3:8.2f} ms/rep "
      f"({nq / t_pipe:,.0f} QPS)")
print(f"  host hop between     : {t_host * 1e3:8.2f} ms/rep "
      f"({nq / t_host:,.0f} QPS)")
print(f"  host-hop overhead    : {(t_host - t_pipe) * 1e3:8.2f} ms/rep")
