"""Point-sharded FastPQ full-scan search over a device mesh.

The FastPQ full-scan path (estimate every point, rescore the best) is
embarrassingly parallel over points: shard the code matrix and the raw
vectors on dim 0, run the estimate + local two-pass on each device, and
merge the per-device (Q, k) results with one all_gather — the same
merge shape as the sharded IVF. Corpus size scales linearly with the
mesh; queries and tables are replicated (KB-scale).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..models.fast_pq import (FastPQ, _build_tables, _resolve_method,
                              pass1_topk)
from ..ops.scan import estimate_scan
from ..utils.padding import round_up
from .mesh import make_mesh, replicate, shard_on_axis0


class ShardedFastPQ:
    """FastPQ search with codes + raw vectors sharded over the mesh.

    Usage matches FastPQ.search: fit/transform happen on one device
    (cheap), ``build(X)`` places the shards, ``search`` runs the
    distributed scan.
    """

    def __init__(self, pq: FastPQ = None, mesh=None, axis="shards", **kw):
        self.pq = FastPQ(**kw) if pq is None else pq
        self.mesh = mesh if mesh is not None else make_mesh(axis=axis)
        self.axis = axis
        self.codes = None
        self.vectors = None
        self.true_n = 0

    def fit(self, X, verbose=False):
        self.pq.fit(X, verbose)
        return self

    def build(self, X, verbose=False):
        n_dev = self.mesh.devices.size
        X = jnp.asarray(X, jnp.float32)
        self.true_n = int(X.shape[0])
        tdata = self.pq.transform(X)
        codes = tdata.packed            # nibble-packed shards (4 bits/block)
        # pad rows so each shard gets an equal slice
        n_pad = round_up(codes.shape[0], n_dev * 8)
        codes = jnp.pad(codes, ((0, n_pad - codes.shape[0]), (0, 0)))
        vecs = jnp.pad(X, ((0, n_pad - X.shape[0]), (0, 0)))
        self.codes, self.vectors = shard_on_axis0(
            self.mesh, codes, vecs, axis=self.axis)
        return self

    def search(self, q, k=1, rescore=None, method="auto"):
        qn = np.asarray(q, dtype=np.float32)
        single = qn.ndim == 1
        if single:
            qn = qn[None]
        k = min(k, self.true_n)
        if not rescore:
            rescore = min(2 * k + 10, self.true_n)
        n_dev = self.mesh.devices.size
        local_n = self.codes.shape[0] // n_dev
        rescore = min(rescore, local_n)
        k = min(k, rescore)
        method = _resolve_method(method)
        qj = replicate(self.mesh, jnp.asarray(qn))
        out = _sharded_search(
            qj, self.codes, self.vectors, self.pq.center_blocks, self.pq.R,
            mesh=self.mesh, axis=self.axis, dpb=self.pq.dims_per_block,
            true_n=self.true_n, k=k, rescore=rescore, method=method)
        return out[0] if single else out


@partial(jax.jit, static_argnames=("mesh", "axis", "dpb", "true_n", "k",
                                   "rescore", "method"))
def _sharded_search(q, codes, vectors, center_blocks, R, *, mesh, axis,
                    dpb, true_n, k, rescore, method):
    def step(q, codes_l, vecs_l):
        me = jax.lax.axis_index(axis)
        local_n = codes_l.shape[0]
        base = me * local_n
        tables = _build_tables(q, center_blocks, R, dpb, True).tables
        est = estimate_scan(codes_l, tables,
                            packed=True)               # (Q, local_n) int32
        # mask global padding rows (only the last shard has any)
        gids = base + jnp.arange(local_n)
        est = jnp.where(gids[None, :] < true_n, est,
                        jnp.iinfo(jnp.int32).max)
        _, cand = pass1_topk(-est.astype(jnp.float32), rescore, method)
        gathered = vecs_l[cand]                        # (Q, rescore, d)
        diff = gathered - q[:, None, :]
        d2 = jnp.einsum("qrd,qrd->qr", diff, diff,
                     precision=jax.lax.Precision.HIGHEST)
        d2 = jnp.where((base + cand) < true_n, d2, jnp.inf)
        _, best = jax.lax.top_k(-d2, k)
        loc_ids = base + jnp.take_along_axis(cand, best, axis=1)
        loc_d2 = jnp.take_along_axis(d2, best, axis=1)
        all_ids = jax.lax.all_gather(loc_ids, axis)    # (S, Q, k)
        all_d2 = jax.lax.all_gather(loc_d2, axis)
        all_ids = jnp.moveaxis(all_ids, 0, 1).reshape(q.shape[0], -1)
        all_d2 = jnp.moveaxis(all_d2, 0, 1).reshape(q.shape[0], -1)
        _, best = jax.lax.top_k(-all_d2, k)
        out = jnp.take_along_axis(all_ids, best, axis=1)
        d2b = jnp.take_along_axis(all_d2, best, axis=1)
        return jnp.where(jnp.isfinite(d2b), out, -1)

    spec_s = P(axis)
    spec_r = P()
    return jax.shard_map(
        step, mesh=mesh, in_specs=(spec_r, spec_s, spec_s),
        out_specs=spec_r, check_vma=False)(q, codes, vectors)
