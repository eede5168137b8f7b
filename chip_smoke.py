#!/usr/bin/env python3
"""Smoke test of tinyknn_tpu on an NVIDIA GPU, at the GloVe-1.2M shape.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --gpus 4   # four cards: the sharded path only

Drives the main path through the public API and checks each result
against the repository's plain references:

  * device: refuses to run unless JAX's platform is 'gpu';
  * full scan (examples/example.py shape: n=16,000, d=128, 1k queries,
    dims_per_block=2): estimates bit-exact against a NumPy oracle,
    FastPQ.search against knn_brute;
  * IVF over the 1,183,514 x 100 angular clustered corpus, 1,087
    clusters, build_probes=1: build, save_ivf / load_ivf round trip,
    PQ and exact engines through query and query_stream(device_out),
    gather mode against bucket mode, recall against the tracked f64
    truth (PQ >= 0.374, exact >= 0.95);
  * precision: knn_brute against the f64 truth (>= 0.995), and the
    share of PQ codes a default-precision encode changes;
  * the CSR kernel (ops/kernels.py) compiled for the card against the
    XLA scans: estimates, final ids, exact distances, and timings;
  * the tests marked ``gpu`` (tests/).

The last line of stdout is one JSON object with "ok" and the device.
Any failed check raises and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TRUTH = "trus64_clustered-1183514-100_k10_nq10000_angular.npy"
SIZE, DIM, NQ, K, CLUSTERS = 1183514, 100, 10000, 10, 1087


def log(*a):
    print(*a, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def recall(ids, truth):
    ids = np.asarray(ids)
    return float(np.mean([len(set(a.tolist()) & set(t.tolist())) / K
                          for a, t in zip(ids, truth)]))


def sorted_d2(X, q, ids):
    """Per-query ascending squared distances of ``ids`` (f64)."""
    ids = np.asarray(ids)
    diff = X[ids].astype(np.float64) - q[:, None, :].astype(np.float64)
    return np.sort((diff ** 2).sum(-1), axis=1)


def time_stream(fn, reps=5):
    """Per-batch milliseconds of ``fn`` (a stream call that returns
    device arrays), after one warm-up call."""
    import jax
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


# ------------------------------------------------------------------ phases

def full_scan(tk):
    n, d, nq = 16000, 128, 1000
    rng = np.random.default_rng(10)
    X = rng.standard_normal((n, d), dtype=np.float32)
    qs = rng.standard_normal((nq, d), dtype=np.float32)
    pq = tk.FastPQ(dims_per_block=2, rotate_dim=None)
    data = pq.fit_transform(X)
    dt = pq.distance_table(qs)
    est = np.asarray(dt.estimate_distances(data))
    tables = np.asarray(dt.tables).astype(np.int64)      # (Q, B, 16)
    codes = np.asarray(data.codes)[:n].astype(np.int64)  # (n, B)
    oracle = np.zeros((nq, n), np.int64)
    for b in range(codes.shape[1]):
        oracle += tables[:, b, :][:, codes[:, b]]
    check(np.array_equal(est, oracle), "full-scan estimate != oracle")
    log("full scan: estimate bit-exact against the NumPy oracle "
        f"({nq} x {n})")
    top = np.asarray(pq.search(qs, data, X, k=10))
    nn = np.asarray(tk.knn_brute(qs, X, k=1))[:, 0]
    r1 = float(np.mean([t in row for t, row in zip(nn, top)]))
    log(f"full scan: FastPQ.search recall1@10 against knn_brute = {r1:.4f}")
    check(r1 >= 0.85, f"full-scan recall1@10 {r1} < 0.85")


def build_index(tk, card, data):
    t0 = time.perf_counter()
    ivf = tk.IVF("angular", CLUSTERS, tk.FastPQ(2))
    ivf.fit(data).build(data, n_probes=1)
    import jax
    jax.block_until_ready(ivf.csr_codes)
    log(f"IVF fit+build: {time.perf_counter() - t0:.1f} s on {card} "
        f"(compilation included; max list {ivf.max_tiles * 128} points)")
    return ivf


def persistence(tk, ivf, queries):
    from tinyknn_tpu.io import load_ivf, save_ivf
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "glove.npz")
        save_ivf(path, ivf)
        loaded = load_ivf(path)
    a = np.asarray(ivf.query(queries[:1000], k=K, n_probes=1, pass_1=84))
    b = np.asarray(loaded.query(queries[:1000], k=K, n_probes=1,
                                pass_1=84))
    check(np.array_equal(a, b), "loaded index answers differently")
    log("persistence: save_ivf/load_ivf round trip answers identically")


def engine_queries(ivf, name, queries, truth, floor, pass_1, Xn, qn):
    import jax.numpy as jnp
    ids = np.asarray(ivf.query(queries, k=K, n_probes=1, pass_1=pass_1))
    check(ids.shape == (NQ, K), f"{name} query shape {ids.shape}")
    out, dropped = ivf.query_stream(jnp.asarray(queries[None]), k=K,
                                    n_probes=1, pass_1=pass_1,
                                    device_out=True)
    stream = np.asarray(out)[0]
    r_q, r_s = recall(ids, truth), recall(stream, truth)
    log(f"{name} engine P=1: recall10@10 query={r_q:.4f} "
        f"query_stream(device_out)={r_s:.4f} (floor {floor}); "
        f"stream dropped pairs={int(dropped)}")
    check(min(r_q, r_s) >= floor, f"{name} recall below {floor}")
    # gather (latency) mode for a small batch against bucket mode: the
    # gather path ranks every list point, the bucket path the kernel's
    # fold, so the two may differ where the fold drops a near-tie
    small = queries[:8]
    a = np.asarray(ivf.query(small, k=K, n_probes=1, pass_1=pass_1,
                             mode="bucket"))
    b = np.asarray(ivf.query(small, k=K, n_probes=1, pass_1=pass_1,
                             mode="gather"))
    overlap = np.mean([len(set(x.tolist()) & set(y.tolist())) / K
                       for x, y in zip(a, b)])
    worst = sorted_d2(Xn, qn[:8], b)[:, -1] / sorted_d2(
        Xn, qn[:8], a)[:, -1]
    log(f"{name} engine Q=8: gather vs bucket id overlap {overlap:.3f}, "
        f"worst-distance ratio gather/bucket max {worst.max():.5f}")
    check(overlap >= 0.9, f"{name} gather/bucket overlap {overlap}")
    return ids


def precision(tk, data, queries, truth, ivf):
    import jax
    import jax.numpy as jnp
    from tinyknn_tpu.models.fast_pq import _encode
    got = np.asarray(tk.knn_brute(queries[:1000], data, K,
                                  metric="angular"))
    agree = recall(got, truth[:1000])
    log(f"precision: knn_brute (HIGHEST) vs f64 truth agreement "
        f"{agree:.4f} on 1000 queries")
    check(agree >= 0.995, f"knn_brute agreement {agree} < 0.995")
    x = jnp.asarray(data[:200000])
    x = x / jnp.linalg.norm(x, axis=1, keepdims=True)
    B, _, dpb = ivf.pq.center_blocks.shape
    x = jnp.pad(x, ((0, 0), (0, B * dpb - x.shape[1])))  # as transform
    args = (x, ivf.pq.center_blocks, ivf.pq.R, ivf.pq.dims_per_block)
    default = np.asarray(_encode(*args))
    with jax.default_matmul_precision("highest"):
        highest = np.asarray(_encode(*args))
    frac = float(np.mean(default != highest))
    log(f"precision: default-precision PQ encode differs from HIGHEST "
        f"in {frac:.6f} of codes (200,000 rows; reported, not gated)")


def kernel_vs_xla(ivf, queries, truth, card, Xn, qn_all):
    """The CSR kernel against the XLA scans at GloVe widths."""
    import jax
    import jax.numpy as jnp
    from unittest import mock
    from tinyknn_tpu.models.ivf import _tiles_to_dense, _augment_queries
    from tinyknn_tpu.ops import platform
    from tinyknn_tpu.ops.kernels import (code_rows, csr_fold_scan,
                                         kernel_tables)
    from tinyknn_tpu.ops.packing import unpack_codes

    C = ivf.tile_offsets.shape[0]
    mt = ivf.max_tiles
    cap = mt * 128
    qc = 32
    qn = qn_all[:qc]
    in_list = (jnp.arange(cap)[None, None, :]
               < ivf.list_counts[:, None, None])

    # int8 estimates at full fold width (every position its own slot)
    tables = ivf.pq.distance_table(qn).tables            # (qc, B, 16)
    B = tables.shape[1]
    t_sel = jnp.broadcast_to(tables.reshape(1, qc, 16 * B),
                             (C, qc, 16 * B))
    enc = csr_fold_scan(kernel_tables(t_sel, B), ivf.csr_codes,
                        ivf.tile_offsets, ivf.list_counts,
                        fold_tiles=mt, max_tiles=mt)
    col_bits = (cap - 1).bit_length()
    dense = _tiles_to_dense(ivf.csr_codes, ivf.tile_offsets, mt)
    onehot = jax.nn.one_hot(unpack_codes(dense)[..., :B], 16,
                            dtype=jnp.int8).reshape(C, cap, 16 * B)
    ref = jax.lax.dot_general(t_sel, onehot, (((2,), (2,)), ((0,), (0,))),
                              preferred_element_type=jnp.int32)
    dec = (enc >> col_bits) - 128 * 2 * code_rows(B)
    pos_ok = jnp.where(in_list, (enc & ((1 << col_bits) - 1))
                       == jnp.arange(cap)[None, None, :], True)
    bad = int(jnp.sum(jnp.where(in_list, dec != ref, False)))
    check(bool(pos_ok.all()) and bad == 0,
          f"kernel int8 estimates differ from XLA at {bad} entries")
    log(f"kernel int8 estimates: bit-exact against the XLA one-hot scan "
        f"at full fold width ({C} lists x {qc} queries x {cap} slots)")

    # exact tiles: bf16-rounded distances within 2^-8 of the XLA einsum
    ivf.set_scan_impl("exact")
    qa = _augment_queries(jnp.asarray(qn))
    q_sel = jnp.broadcast_to(qa[None], (C,) + qa.shape)
    enc = csr_fold_scan(q_sel, ivf.csr_vecs, ivf.tile_offsets,
                        ivf.list_counts, fold_tiles=mt, max_tiles=mt)
    val = jax.lax.bitcast_convert_type(enc & -65536, jnp.float32)
    vecs = _tiles_to_dense(ivf.csr_vecs, ivf.tile_offsets, mt)
    ref = jnp.maximum(jnp.einsum("cqd,cpd->cqp", q_sel, vecs,
                                 preferred_element_type=jnp.float32), 0)
    err = jnp.where(in_list, jnp.abs(val - ref), 0)
    rel = float(jnp.max(err / jnp.maximum(ref, 1e-6)))
    # bf16 output rounding: half an ulp, at most 2^-8 of the value; 1e-5
    # absolute covers f32 summation order on near-cancelling sums
    over = int(jnp.sum(err > 2.0 ** -8 * ref + 1e-5))
    log(f"kernel exact distances: max relative difference {rel:.5f} "
        f"from the XLA exact contraction; {over} beyond 2^-8 + 1e-5")
    check(over == 0, f"exact kernel distances off at {over} entries")

    # end to end: the same stream through the kernel and the XLA scans
    batch = jnp.asarray(queries[None])
    timings = {}

    def run(name, p1):
        def call():
            return ivf.query_stream(batch, k=K, n_probes=1, pass_1=p1,
                                    device_out=True)[0]
        ids = np.asarray(call())[0]
        timings[name] = time_stream(call)
        return ids

    ivf.set_scan_impl("auto")            # the kernel on the GPU
    pq_k = run("pq_kernel", 84)
    ivf.set_scan_impl("xla")
    pq_x = run("pq_xla", 84)
    dk, dx = sorted_d2(Xn, qn_all, pq_k), sorted_d2(Xn, qn_all, pq_x)
    same = float(np.mean(np.all(np.isclose(dk, dx, rtol=1e-5, atol=0),
                                axis=1)))
    rk, rx = recall(pq_k, truth), recall(pq_x, truth)
    log(f"PQ final ids, kernel vs XLA: sorted distances equal on "
        f"{same:.4f} of queries; recall {rk:.4f} vs {rx:.4f}")
    check(same >= 0.99 and abs(rk - rx) <= 0.005,
          "PQ kernel path disagrees with the XLA path")

    ivf.set_scan_impl("exact")           # the exact kernel on the GPU
    ex_k = run("exact_kernel", None)
    with mock.patch.object(platform, "use_kernels", return_value=False):
        ex_x = run("exact_xla", None)
    dk, dx = sorted_d2(Xn, qn_all, ex_k), sorted_d2(Xn, qn_all, ex_x)
    dominated = np.all(dk <= dx * (1 + 1e-3) + 1e-3, axis=1)
    dups = sum(len(set(r.tolist())) != K for r in ex_k)
    log(f"exact final ids, kernel vs XLA: distance-dominated at 1e-3 on "
        f"{dominated.mean():.4f} of queries, {dups} with duplicate ids; "
        f"recall {recall(ex_k, truth):.4f} vs {recall(ex_x, truth):.4f}")
    check(dominated.all() and dups == 0,
          "exact kernel path not dominated by the XLA path")
    log(f"timings on {card}, query_stream(device_out=True), "
        f"{NQ} queries per batch, P=1, ms per batch: "
        + ", ".join(f"{k}={v:.3f}" for k, v in timings.items()))
    return timings


def gpu_tests():
    import pytest
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(HERE, "tests")])
    check(rc == 0, f"GPU-marked tests failed (pytest exit {rc})")
    log("GPU-marked tests: passed")


def sharded(tk, data, queries, truth, n_gpus, Xn, qn):
    """Cluster-sharded IVF and point-sharded FastPQ over n_gpus cards,
    each against its single-device counterpart."""
    from tinyknn_tpu.parallel import ShardedFastPQ, ShardedIVF, make_mesh
    mesh = make_mesh(n_gpus)
    single = tk.IVF("angular", CLUSTERS, tk.FastPQ(2))
    single.fit(data).build(data, n_probes=1)
    shard = ShardedIVF("angular", CLUSTERS, tk.FastPQ(2), mesh=mesh)
    shard.fit(data).build(data, n_probes=1)
    for arr in (shard.csr_codes, shard.csr_ids, shard.list_vecs):
        sizes = [s.data.size for s in arr.addressable_shards]
        devs = {s.device for s in arr.addressable_shards}
        check(len(devs) == n_gpus and max(sizes) == min(sizes)
              and max(sizes) * n_gpus == arr.size,
              f"CSR array not split evenly over {n_gpus} cards: {sizes}")
    log(f"sharded IVF: CSR codes, ids and vectors split evenly, one "
        f"quarter per card over {n_gpus} cards")
    for engine, p1 in (("pq", 84), ("exact", None)):
        if engine == "exact":
            single.set_scan_impl("exact")
            shard.set_scan_impl("exact")
        a = np.asarray(single.query(queries, k=K, n_probes=1, pass_1=p1))
        b = np.asarray(shard.query(queries, k=K, n_probes=1, pass_1=p1))
        da, db = sorted_d2(Xn, qn, a), sorted_d2(Xn, qn, b)
        dom = float(np.mean(db[:, -1] <= da[:, -1] * (1 + 1e-5) + 1e-6))
        overlap = np.mean([len(set(x.tolist()) & set(y.tolist())) / K
                           for x, y in zip(a, b)])
        log(f"sharded IVF {engine}: overlap with single-device ids "
            f"{overlap:.4f}, worst distance no worse on {dom:.4f} of "
            f"queries, recall {recall(b, truth):.4f} vs "
            f"{recall(a, truth):.4f}")
        check(overlap >= 0.99 and dom >= 0.999,
              f"sharded {engine} disagrees with single-device IVF")
    rng = np.random.default_rng(10)
    Xf = rng.standard_normal((16000, 128), dtype=np.float32)
    qf = rng.standard_normal((1000, 128), dtype=np.float32)
    pq = tk.FastPQ(2, rotate_dim=None, seed=5)
    a = np.asarray(pq.search(qf, pq.fit_transform(Xf), Xf, k=K))
    spq = ShardedFastPQ(tk.FastPQ(2, rotate_dim=None, seed=5), mesh=mesh)
    b = np.asarray(spq.fit(Xf).build(Xf).search(qf, k=K))
    # each card rescores its own candidate pool, a superset of the
    # single-device pool: the sharded result ties or dominates
    da, db = sorted_d2(Xf, qf, a), sorted_d2(Xf, qf, b)
    dom = float(np.mean(db[:, -1] <= da[:, -1] * (1 + 1e-5) + 1e-6))
    tru = np.asarray(tk.knn_brute(qf, Xf, K))
    ra, rb = recall(a, tru), recall(b, tru)
    log(f"ShardedFastPQ vs FastPQ.search: worst distance no worse on "
        f"{dom:.4f} of queries; recall10@10 {rb:.4f} vs {ra:.4f}")
    check(dom >= 0.999 and rb >= ra,
          "ShardedFastPQ worse than FastPQ.search")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gpus", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded path, on four cards")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "tinyknn_tpu")):
        sys.exit("chip_smoke.py must run from a checkout of the repository")
    sys.path.insert(0, HERE)
    import jax
    if jax.default_backend() != "gpu":
        sys.exit(f"no GPU: JAX's platform is {jax.default_backend()!r}")
    devices = jax.devices()
    if len(devices) < args.gpus:
        sys.exit(f"--gpus {args.gpus} needs {args.gpus} cards, JAX sees "
                 f"{len(devices)}")
    import tinyknn_tpu as tk
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    card = f"{smi[0]} (power limit {smi[0].split(',')[-1].strip()})"
    log("\n".join(smi))
    log(f"device_kind={devices[0].device_kind} count={len(devices)} "
        f"jax={jax.__version__} compile cache="
        f"{tk.utils.enable_compilation_cache()}")

    data, queries = tk.utils.make_clustered(SIZE, DIM, NQ)
    truth = np.load(os.path.join(HERE, TRUTH))
    # angular: distances between unit vectors, as the index sees them
    Xn = data / np.linalg.norm(data, axis=1, keepdims=True)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    if args.gpus > 1:
        sharded(tk, data, queries, truth, args.gpus, Xn, qn)
    else:
        full_scan(tk)
        ivf = build_index(tk, card, data)
        persistence(tk, ivf, queries)
        engine_queries(ivf, "PQ", queries, truth, 0.374, 84, Xn, qn)
        ivf.set_scan_impl("exact")
        engine_queries(ivf, "exact", queries, truth, 0.95, None, Xn, qn)
        ivf.set_scan_impl("auto")
        precision(tk, data, queries, truth, ivf)
        kernel_vs_xla(ivf, queries, truth, card, Xn, qn)
        gpu_tests()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
