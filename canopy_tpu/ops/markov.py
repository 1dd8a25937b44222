"""Markov (dependency) submodel solvers.

The north star names "sparse factorization for Markov/dependency
submodels" (BASELINE.json; reference capability implied by the GLM /
periodic-test repairable-component semantics).  PRA dependency submodels
are continuous-time Markov chains over component-group states whose state
probabilities feed basic events of the surrounding fault tree.

Accelerator-friendly design:

* **Transients** — uniformization (Jensen's method): strictly
  matmul/matvec compute (matrix-unit shaped) with an a-priori truncation bound,
  batched over time points and epistemic trials with ``vmap``.
* **Sparse triangular solves** — blocked forward/backward substitution
  compiled on the host (:func:`compile_blocked_triangular`): rows are
  cut into fixed blocks; each block's intra-block coupling becomes a
  dense (B, B) triangle solved as a dense matmul, and its dependencies on
  earlier blocks become one ELL gather (the propagation engines' access
  pattern).  The device executes a single ``lax.scan`` over blocks —
  static shapes, one trace — so a 10k-state bidiagonal chain (which a
  level schedule would unroll into 10k traced ops) costs n/B scan steps.
* **Sparse LU** (:func:`sparse_lu`) — host up-looking row
  factorization (no pivoting: CTMC balance matrices are diagonally
  dominated; a zero-pivot check guards misuse), emitting L and U as
  blocked triangular programs.  Factorization is once-per-submodel
  host work; the *solves* — the per-trial/per-time hot path — run on
  device.  :func:`markov_stationary` routes CSR input
  through it, so stationary distributions of 10k+-state chains never
  build an (S, S) dense matrix (dense input keeps the jit-traceable
  dense solve).

Tested against ``scipy.sparse`` oracles at 10k+ states
(``tests/test_markov.py``).
"""

from __future__ import annotations

import dataclasses
import heapq
import math

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import LogicError

__all__ = ["markov_transient", "markov_stationary",
           "compile_blocked_triangular", "BlockedTriangular",
           "sparse_lu", "SparseLU", "triangular_solve_levels"]


def _poisson_terms(rate: float, tol: float) -> int:
    """Truncation point: smallest K with tail mass below tol."""
    total = 0.0
    log_term = -rate  # log Poisson(rate; 0)
    kk = 0
    while total < 1.0 - tol and kk < 100000:
        total += math.exp(log_term)
        kk += 1
        log_term += math.log(rate) - math.log(kk)
    return max(kk, 2)


def markov_transient(Q: jnp.ndarray, p0: jnp.ndarray, t: float,
                     tol: float = 1e-12) -> jnp.ndarray:
    """Transient state distribution p(t) of a CTMC with generator Q.

    ``Q``: (S, S) generator (rows sum to 0, off-diagonals >= 0; the
    convention is p' = p @ Q for a row-vector distribution). ``p0``: (S,)
    or batched (..., S). Uniformization with host-computed truncation.
    """
    Q = jnp.asarray(Q, dtype=jnp.float64)
    diag = jnp.diagonal(Q)
    rate_bound = float(np.max(-np.asarray(diag))) * float(t)
    if rate_bound == 0.0:
        return jnp.broadcast_to(p0, p0.shape)
    lam = rate_bound * 1.0000001
    M = jnp.eye(Q.shape[0], dtype=Q.dtype) + Q * (float(t) / lam)
    K = _poisson_terms(lam, tol)

    # Poisson weights, computed stably in log space on host.
    log_w = np.empty(K)
    log_w[0] = -lam
    for k in range(1, K):
        log_w[k] = log_w[k - 1] + math.log(lam) - math.log(k)
    weights = jnp.asarray(np.exp(log_w))

    def step(carry, w):
        pk, acc = carry
        acc = acc + w * pk
        pk = pk @ M
        return (pk, acc), None

    acc0 = jnp.zeros_like(p0, dtype=Q.dtype)
    (final_p, acc), _ = jax.lax.scan(step, (p0.astype(Q.dtype), acc0),
                                     weights)
    return acc


# ---------------------------------------------------------------------------
# Blocked sparse triangular substitution.


@dataclasses.dataclass
class BlockedTriangular:
    """A host-compiled sparse triangular system ``T x = b``.

    ``dense[k]`` holds block k's intra-block coupling (including the
    diagonal) as a dense (B, B) lower triangle in *solve order* — for
    upper systems the rows/columns are reversed on the host so the
    device always runs the same lower-triangular scan.  ``off_idx`` /
    ``off_val`` hold each row's dependencies on already-solved entries
    (ELL padded, index 0 with value 0).  ``row_order`` maps solve order
    back to original row indices.
    """

    n: int
    block: int
    n_blocks: int
    dense: jnp.ndarray     # (n_blocks, B, B)
    off_idx: jnp.ndarray   # (n_blocks, B, F) into the solve-order vector
    off_val: jnp.ndarray   # (n_blocks, B, F)
    rhs_order: np.ndarray  # original row index per solve-order position

    def solve(self, b: jnp.ndarray) -> jnp.ndarray:
        """Solve ``T x = b``; ``b`` may carry leading batch axes."""
        return _blocked_solve(self, jnp.asarray(b))


def _blocked_solve(bt: BlockedTriangular, b: jnp.ndarray) -> jnp.ndarray:
    batch_shape = b.shape[:-1]
    n, B, nb = bt.n, bt.block, bt.n_blocks
    n_pad = nb * B
    bp = b[..., jnp.asarray(bt.rhs_order)]
    bp = jnp.pad(bp, [(0, 0)] * len(batch_shape) + [(0, n_pad - n)])
    bp = jnp.moveaxis(bp.reshape(batch_shape + (nb, B)),
                      -2, 0)                      # (nb, ..., B)

    def step(x, blk):
        dense, idx, val, b_blk, start = blk
        gathered = x[..., idx]                    # (..., B, F)
        rhs = b_blk - jnp.sum(val * gathered, axis=-1)
        flat = rhs.reshape(-1, B).T               # (B, batch)
        xb = jax.lax.linalg.triangular_solve(
            dense, flat, left_side=True, lower=True)
        xb = xb.T.reshape(rhs.shape)
        x = jax.lax.dynamic_update_slice_in_dim(x, xb, start, axis=-1)
        return x, None

    x0 = jnp.zeros(batch_shape + (n_pad,), dtype=bp.dtype)
    starts = jnp.arange(nb, dtype=jnp.int32) * B
    x, _ = jax.lax.scan(step, x0,
                        (bt.dense, bt.off_idx, bt.off_val, bp, starts))
    inv = np.empty(n, dtype=np.int64)
    inv[bt.rhs_order] = np.arange(n)
    return x[..., :n][..., jnp.asarray(inv)]


def compile_blocked_triangular(indptr: np.ndarray, indices: np.ndarray,
                               data: np.ndarray, diag: np.ndarray,
                               lower: bool = True, block: int = 128,
                               dtype=jnp.float64) -> BlockedTriangular:
    """Compile a sparse triangular matrix for device substitution.

    ``indptr/indices/data``: CSR of the *strictly* triangular part
    (lower or upper per ``lower``); ``diag``: the diagonal vector.
    Rows must satisfy the triangularity they claim.
    """
    n = len(diag)
    if n == 0:
        raise LogicError("empty triangular system")
    if np.any(np.asarray(diag) == 0.0):
        raise LogicError("zero diagonal in triangular system")
    # Solve order: natural for lower, reversed for upper — either way
    # position p depends only on positions < p (vectorized host build).
    order = np.arange(n) if lower else np.arange(n - 1, -1, -1)
    pos = np.empty(n, dtype=np.int64)
    pos[order] = np.arange(n)
    nb = -(-n // block)
    indptr = np.asarray(indptr)
    indices = np.asarray(indices, dtype=np.int64)
    data = np.asarray(data, dtype=np.float64)
    row_of = np.repeat(np.arange(n), np.diff(indptr))
    if len(indices) and (np.any(indices >= row_of) if lower
                         else np.any(indices <= row_of)):
        raise LogicError("entry violates claimed triangularity")
    p_of = pos[row_of]
    q_of = pos[indices] if len(indices) else indices
    same = (q_of // block) == (p_of // block)
    dense = np.zeros((nb, block, block))
    np.add.at(dense, (p_of[same] // block, p_of[same] % block,
                      q_of[same] % block), data[same])
    kk = np.arange(nb * block)
    dense[kk // block, kk % block, kk % block] = np.concatenate(
        [np.asarray(diag, dtype=np.float64)[order],
         np.ones(nb * block - n)])
    # Off-block entries: pack per row (CSR entries are grouped by row,
    # so slot = index - first index of that row among off entries).
    op_, oq_, ov_ = p_of[~same], q_of[~same], data[~same]
    counts = np.bincount(op_, minlength=nb * block) if len(op_) else \
        np.zeros(nb * block, dtype=np.int64)
    F = max(int(counts.max()) if len(op_) else 0, 1)
    off_idx = np.zeros((nb, block, F), dtype=np.int32)
    off_val = np.zeros((nb, block, F))
    if len(op_):
        # Entries of one row are contiguous (CSR order), so the running
        # index minus the row's first running index is the slot.
        uniq, first_at = np.unique(op_, return_index=True)
        row_first = np.zeros(nb * block, dtype=np.int64)
        row_first[uniq] = first_at
        slot = np.arange(len(op_)) - row_first[op_]
        off_idx[op_ // block, op_ % block, slot] = oq_
        off_val[op_ // block, op_ % block, slot] = ov_
    return BlockedTriangular(
        n=n, block=block, n_blocks=nb,
        dense=jnp.asarray(dense, dtype=dtype),
        off_idx=jnp.asarray(off_idx),
        off_val=jnp.asarray(off_val, dtype=dtype),
        rhs_order=order)


def triangular_solve_levels(indptr: np.ndarray, indices: np.ndarray,
                            data: jnp.ndarray, diag: jnp.ndarray,
                            b: jnp.ndarray) -> jnp.ndarray:
    """Sparse lower-triangular solve ``L x = b`` (CSR strictly-lower +
    diagonal vector; ``b`` may carry leading batch axes).

    Compatibility wrapper over :func:`compile_blocked_triangular` — the
    former per-row level schedule emitted O(n) traced ops and could not
    scale past toy sizes; the blocked scan handles 10k+ states and
    arbitrary dependency-chain depth.
    """
    bt = compile_blocked_triangular(
        np.asarray(indptr), np.asarray(indices), np.asarray(data),
        np.asarray(diag), lower=True)
    return bt.solve(b)


# ---------------------------------------------------------------------------
# Sparse LU (host factorization, device solves).


@dataclasses.dataclass
class SparseLU:
    """LU factors compiled for device substitution (``P A P^T = L U``,
    unit lower L, symmetric fill-reducing permutation P).  ``solve(b)``
    runs two blocked scans on device."""

    L: BlockedTriangular
    U: BlockedTriangular
    n: int
    nnz_factors: int
    perm: np.ndarray | None = None      # solve-order row for position p

    def solve(self, b: jnp.ndarray) -> jnp.ndarray:
        b = jnp.asarray(b)
        if self.perm is not None:
            b = b[..., jnp.asarray(self.perm)]
        x = self.U.solve(self.L.solve(b))
        if self.perm is not None:
            inv = np.empty(self.n, dtype=np.int64)
            inv[self.perm] = np.arange(self.n)
            x = x[..., jnp.asarray(inv)]
        return x


def _rcm_order(indptr, indices, n) -> np.ndarray:
    """Reverse Cuthill-McKee over the symmetrized pattern — bandwidth
    (hence LU fill) reduction for unstructured sparsity."""
    adj: list[list[int]] = [[] for _ in range(n)]
    for i in range(n):
        for c in indices[indptr[i]:indptr[i + 1]]:
            c = int(c)
            if c != i:
                adj[i].append(c)
                adj[c].append(i)
    deg = np.array([len(set(a)) for a in adj])
    visited = np.zeros(n, dtype=bool)
    order = []
    for start in np.argsort(deg, kind="stable"):
        if visited[start]:
            continue
        queue = [int(start)]
        visited[start] = True
        head = 0
        while head < len(queue):
            v = queue[head]
            head += 1
            order.append(v)
            for u in sorted(set(adj[v]), key=lambda u: (deg[u], u)):
                if not visited[u]:
                    visited[u] = True
                    queue.append(u)
    return np.array(order[::-1], dtype=np.int64)


def sparse_lu(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
              n: int, pivot_tol: float | None = None,
              block: int = 128, ordering: str = "rcm") -> SparseLU:
    """Up-looking row LU of a sparse matrix in CSR form (no pivoting).

    Intended for CTMC balance matrices (diagonally dominated after the
    normalization-row substitution, so pivoting-free elimination is
    stable); raises :class:`LogicError` on a (near-)zero pivot.
    ``pivot_tol`` defaults to a *per-row relative* threshold —
    ``1e3 * eps * max|row i of A|`` — so a nearly singular matrix raises
    instead of silently producing a garbage factorization, while rows
    whose rates are legitimately many orders of magnitude below the
    global ``max|A|`` (rare-failure rows alongside fast-repair rows in
    one CTMC) are judged against their own scale; the post-solve
    residual check in :func:`markov_stationary` rejects genuinely
    inaccurate factorizations that slip past it.  The
    factorization is host work done once per submodel; both factors
    compile to :class:`BlockedTriangular` programs so repeated solves
    (per trial / per time point) run on device.

    ``ordering``: "rcm" (default) applies a symmetric reverse
    Cuthill-McKee permutation before elimination — unstructured
    sparsity patterns otherwise fill in catastrophically; "natural"
    keeps the given order (already-banded systems).
    """
    perm = None
    if ordering == "rcm":
        perm = _rcm_order(indptr, indices, n)
        # Permute A -> A[perm][:, perm] on the host (CSR rebuild).
        inv = np.empty(n, dtype=np.int64)
        inv[perm] = np.arange(n)
        new_indptr = np.zeros(n + 1, dtype=np.int64)
        new_idx, new_dat = [], []
        for p in range(n):
            i = int(perm[p])
            cs = inv[indices[indptr[i]:indptr[i + 1]]]
            vs = data[indptr[i]:indptr[i + 1]]
            srt = np.argsort(cs, kind="stable")
            new_idx.append(cs[srt])
            new_dat.append(np.asarray(vs)[srt])
            new_indptr[p + 1] = new_indptr[p] + len(cs)
        indptr = new_indptr
        indices = np.concatenate(new_idx) if new_idx else \
            np.zeros(0, dtype=np.int64)
        data = np.concatenate(new_dat) if new_dat else np.zeros(0)
    row_tol = None
    if pivot_tol is None:
        # Per-row scale of the (permuted) input matrix: a row's pivot is
        # near-zero relative to its OWN rates, not the global max —
        # CTMCs legitimately mix ~1e6 repair rows with ~1e-9 failure
        # rows, and a global threshold would reject the latter.
        row_tol = np.zeros(n, dtype=np.float64)
        absd = np.abs(data)
        for i in range(n):
            seg = absd[indptr[i]:indptr[i + 1]]
            row_tol[i] = seg.max() if len(seg) else 0.0
        row_tol *= 1e3 * np.finfo(np.float64).eps
    U_cols: list[np.ndarray] = [None] * n   # ascending, first is diag
    U_vals: list[np.ndarray] = [None] * n
    L_rows: list[list[tuple[int, float]]] = [None] * n
    nnz = 0
    for i in range(n):
        work: dict[int, float] = {}
        for c, v in zip(indices[indptr[i]:indptr[i + 1]],
                        data[indptr[i]:indptr[i + 1]]):
            work[int(c)] = work.get(int(c), 0.0) + float(v)
        heap = [c for c in work if c < i]
        heapq.heapify(heap)
        in_heap = set(heap)
        l_row = []
        while heap:
            k = heapq.heappop(heap)
            in_heap.discard(k)
            f = work.pop(k) / U_vals[k][0]
            if f == 0.0:
                continue
            l_row.append((k, f))
            cols_k, vals_k = U_cols[k], U_vals[k]
            for c, v in zip(cols_k[1:], vals_k[1:]):
                c = int(c)
                if c in work:
                    work[c] -= f * v
                else:
                    work[c] = -f * v
                    if c < i and c not in in_heap:
                        heapq.heappush(heap, c)
                        in_heap.add(c)
        piv = work.pop(i, 0.0)
        tol_i = pivot_tol if row_tol is None else row_tol[i]
        if abs(piv) <= tol_i:
            raise LogicError(
                f"sparse_lu: (near-)zero pivot {piv:.3e} at row {i} "
                f"(threshold {tol_i:.3e}; matrix is singular or "
                "needs pivoting)")
        cols = np.array([i] + sorted(work), dtype=np.int64)
        vals = np.array([piv] + [work[c] for c in sorted(work)])
        U_cols[i], U_vals[i] = cols, vals
        L_rows[i] = l_row
        nnz += len(cols) + len(l_row)

    # CSR of strictly-lower L (unit diag) and strictly-upper U.
    def to_csr(rows_cols_vals):
        indptr_o = np.zeros(n + 1, dtype=np.int64)
        cols_o, vals_o = [], []
        for i, row in enumerate(rows_cols_vals):
            for c, v in row:
                cols_o.append(c)
                vals_o.append(v)
            indptr_o[i + 1] = len(cols_o)
        return (indptr_o, np.array(cols_o, dtype=np.int64),
                np.array(vals_o))

    l_ip, l_ix, l_vx = to_csr(L_rows)
    u_rows = [[(int(c), float(v)) for c, v in
               zip(U_cols[i][1:], U_vals[i][1:])] for i in range(n)]
    u_ip, u_ix, u_vx = to_csr(u_rows)
    u_diag = np.array([U_vals[i][0] for i in range(n)])
    L = compile_blocked_triangular(l_ip, l_ix, l_vx, np.ones(n),
                                   lower=True, block=block)
    U = compile_blocked_triangular(u_ip, u_ix, u_vx, u_diag,
                                   lower=False, block=block)
    return SparseLU(L=L, U=U, n=n, nnz_factors=nnz, perm=perm)


def markov_stationary(Q, method: str = "auto") -> jnp.ndarray:
    """Stationary distribution: solve pi @ Q = 0, sum(pi) = 1.

    ``Q`` may be dense (array) or a CSR triple ``(indptr, indices,
    data)``; ``method`` is "auto" | "dense" | "sparse".  Auto keeps a
    dense ``Q`` on the dense device solve (jit-traceable, one
    ``jnp.linalg.solve``) and routes CSR input through the sparse
    path: one balance column replaced by the normalization constraint,
    ``A^T`` factorized once on the host (:func:`sparse_lu`), the two
    substitution scans on device — no (S, S) dense matrix is ever
    built.  ``method="sparse"`` with a dense ``Q`` forces host
    conversion (concrete arrays only).
    """
    if isinstance(Q, tuple):
        indptr, indices, data = Q
        S = len(indptr) - 1
        dense_in = None
    else:
        dense_in = Q
        S = Q.shape[0]
    if method == "auto":
        method = "dense" if dense_in is not None else "sparse"
    if method == "dense":
        if dense_in is None:
            raise LogicError("dense stationary solve needs a dense Q")
        Qj = jnp.asarray(dense_in, dtype=jnp.float64)
        A = jnp.concatenate([Qj[:, :-1], jnp.ones((S, 1), dtype=Qj.dtype)],
                            axis=1)
        b = jnp.zeros(S, dtype=Qj.dtype).at[-1].set(1.0)
        return jnp.linalg.solve(A.T, b)
    # Sparse: build A^T in CSR on the host (vectorized).  A = Q with
    # its last column replaced by ones, so A^T row S-1 is all-ones and
    # A^T row j (< S-1) holds Q[:, j].
    if dense_in is not None:
        d = np.asarray(dense_in, dtype=np.float64)
        rows, cols = np.nonzero(d)
        vals = d[rows, cols]
    else:
        rows = np.repeat(np.arange(S), np.diff(np.asarray(indptr)))
        cols = np.asarray(indices, dtype=np.int64)
        vals = np.asarray(data, dtype=np.float64)
    keep = cols != S - 1               # replaced by the ones column
    # Transposed coordinates: (row=col, col=row), plus the ones row.
    t_rows = np.concatenate([cols[keep], np.full(S, S - 1)])
    t_cols = np.concatenate([rows[keep], np.arange(S)])
    t_vals = np.concatenate([vals[keep], np.ones(S)])
    order = np.lexsort((t_cols, t_rows))
    t_rows, t_cols, t_vals = t_rows[order], t_cols[order], t_vals[order]
    ip = np.zeros(S + 1, dtype=np.int64)
    np.add.at(ip, t_rows + 1, 1)
    ip = np.cumsum(ip)
    lu = sparse_lu(ip, t_cols, t_vals, S)
    b = jnp.zeros(S, dtype=jnp.float64).at[-1].set(1.0)
    pi = lu.solve(b)
    # Validate the solve: pivoting-free elimination on a matrix that
    # violates the dominance assumption can complete yet be inaccurate;
    # check the balance residual on the host before returning.
    pi_h = np.asarray(pi, dtype=np.float64)
    resid = np.zeros(S)
    np.add.at(resid, t_rows, t_vals * pi_h[t_cols])
    resid[-1] -= 1.0
    scale = max(float(np.max(np.abs(t_vals))), 1.0)
    if not np.all(np.abs(resid) <= 1e-8 * scale):
        raise LogicError(
            f"markov_stationary: sparse solve residual "
            f"{np.max(np.abs(resid)):.3e} exceeds 1e-8*|A| — the "
            "balance matrix needs pivoting (use method='dense')")
    return pi
