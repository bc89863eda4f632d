"""The serial schedule (S) of the reference simulator, normalized min-sum
and tanh-product BP, plain numpy in float32: one check row per layer, in
natural row order, with a convergence test after every row.

State per shot: the posterior LLR of every variable, starting at the
channel prior (`decode.prior_llr`), a check-to-variable message per edge,
starting at 0, and the syndrome estimate, the parity of H times the hard
decision (posterior < 0), starting from the prior's uniform decision.
Iteration `it` visits rows r = 0 .. m-1. Row r reads v = posterior -
message on each of its edges and forms its new messages as the flooding
and layered reference does (`decode._ms`, `decode._bp`); then each edge
adds

    delta_e = new_e - message_e

to its message and to its variable's posterior. Under min-sum new_e is a
product a_e * b_e (a = +-beta, b the magnitude), and delta_e is that
product and the subtraction rounded once, as a fused multiply-add
(`fma32`). Under BP a_e = +-1, so the product is exact and the fused and
unfused forms agree.

Every variable whose hard decision the row flipped toggles the estimate of
every check row that meets it; the estimate is never recomputed from the
posterior. After the row, a shot still running whose estimate equals its
syndrome has converged after it + 1 iterations and is frozen from the next
row on (its deltas are 0). The test comes after the row's update, so a
shot with a zero syndrome still runs row 0 of iteration 0 and stops with
n_iter 1. A shot that never converges stops after max_iter iterations.

Consecutive rows that share no variable read nothing that the others
write, so the messages of such a run of rows (a layer of
`decode.layer_rows`) are formed together; their estimate updates and tests
still go a row at a time, and a shot that converges inside the run gets
none of the run's later rows.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from portbench.reference.decode import (F32, Graph, _bp, _parts,
                                        layer_rows, prior_llr)

FROZEN = 1 << 30                     # added to a frozen shot's mismatch count
# the 29 low mantissa bits of a float64 that float32 drops, and their value
# where the float64 lies on a float32 tie
LOW29 = np.int64((1 << 29) - 1)
TIE29 = np.int64(1 << 28)
TINY32 = np.float64(2.0 ** -125)     # below it float32 has fewer bits


def fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Correctly rounded float32 a * b + c, elementwise.

    The product is exact in float64, and rounding the float64 sum s to
    float32 gives the fma's result unless s lies on a float32 tie (or in
    float32's subnormal range, but not 0, which a two-sum gives only
    where it is exact) while the exact sum does not: those few
    are rounded to odd first, moved one float64 ulp toward the exact sum,
    whose error the two-sum gives."""
    p = a.astype(np.float64) * b                          # exact
    s = p + c
    bits = s.view(np.int64)
    near = ((bits & LOW29) == TIE29) | ((np.abs(s) < TINY32) & (s != 0))
    i = np.flatnonzero(near)
    if i.size:
        pi, si = p.reshape(-1)[i], s.reshape(-1)[i]
        ci = np.asarray(c, dtype=np.float64).reshape(-1)[i]
        bb = si - pi
        err = (pi - (si - bb)) + (ci - bb)                # si + err == pi + ci
        bi = bits.reshape(-1)[i]
        step = np.where((err > 0) == (si > 0), 1, -1)
        bits.reshape(-1)[i] = np.where((err != 0) & ((bi & 1) == 0),
                                       bi + step, bi)
    return s.astype(F32)


def _neighbours(H: np.ndarray, g: Graph) -> List[Tuple[np.ndarray,
                                                       np.ndarray]]:
    """Per row r: the check rows that meet r's variables, and the float32
    (rows, deg) count of their meetings with each of r's variables (the
    flips of r's variables toggle a check row's estimate by their sum mod
    2)."""
    out = []
    for r in range(g.m):
        cols = H[:, g.edge_var[g.row_ptr[r]:g.row_ptr[r + 1]]]
        near = np.nonzero(cols.any(axis=1))[0]
        out.append((near, cols[near].astype(F32)))
    return out


def decode(H: np.ndarray, syn: np.ndarray, p: float, kind: str,
           schedule: str, max_iter: int, beta: float = 0.75,
           eps: float = 1e-6
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Decode (B, m) 0/1 syndromes under the serial schedule: (e_hat uint8
    (B, n), n_iter int32 (B,), converged bool (B,), posterior float32
    (B, n))."""
    if schedule.upper() != "S":
        raise ValueError(f"the serial reference runs schedule S, got "
                         f"{schedule!r}")
    kind = kind.upper()
    if kind not in ("MS", "BP"):
        raise ValueError(f"kind MS or BP, got {kind!r}")
    H = (np.asarray(H) % 2).astype(np.uint8)
    g = Graph.build(H)
    nbrs = _neighbours(H, g)
    syn = np.asarray(syn).astype(np.uint8)
    B = syn.shape[0]
    beta32 = F32(beta)
    clamp = F32(1.0 - float(eps))
    lch = prior_llr(p)

    post_out = np.empty((B, g.n), dtype=F32)
    n_iter = np.full(B, max_iter, dtype=np.int32)
    conv = np.zeros(B, dtype=bool)
    # runs of consecutive rows that share no variable: no row of a run
    # reads what another writes, so a run's messages are formed at once;
    # the estimate and the test still go a row at a time
    runs = []
    for R in layer_rows(H, "L"):
        e0, e1 = g.row_ptr[R[0]], g.row_ptr[R[-1] + 1]
        parts = [(q.rows, q.edges - e0) for q in _parts(g, R)]
        if len(parts) == 1:            # one degree: the edges in order
            parts = [(parts[0][0], slice(0, e1 - e0), parts[0][1].shape)]
        else:
            parts = [(q, E.ravel(), E.shape) for q, E in parts]
        rows = [(r, g.row_ptr[r] - e0, g.row_ptr[r + 1] - e0) for r in R]
        runs.append((e0, e1, g.edge_var[e0:e1], parts, rows))
    # the live shots' state, a column each
    live = np.arange(B)
    post = np.full((g.n, B), lch, dtype=F32)
    msg = np.zeros((g.edge_var.size, B), dtype=F32)
    ss = F32(1.0) - F32(2.0) * syn.T.astype(F32)
    bss = beta32 * ss                  # min-sum's factor a, before the signs
    # where the estimate differs from the syndrome, and on how many rows; a
    # shot frozen in this iteration has FROZEN added to its count
    mis = (((H.sum(axis=1) & 1) * int(lch < 0))[:, None]
           != syn.T).astype(np.uint8)
    W = mis.sum(axis=0, dtype=np.int64)
    for it in range(max_iter):
        if live.size == 0:
            break
        running = np.ones(live.size, dtype=bool)
        frozen = False
        for e0, e1, V, parts, rows in runs:
            old = msg[e0:e1]
            pos = post[V]
            v = pos - old
            delta = np.empty_like(v)
            for R, E, shape in parts:
                vr = v[E].reshape(shape + (-1,))            # (rows, deg, B)
                if kind == "MS":
                    # new_e = a_e * b_e: a_e = beta ss (-1)^(negatives
                    # among the row's v) sgn(v_e), b_e = the second
                    # smallest |v| of the row where |v_e| is the smallest,
                    # else the smallest
                    mag = np.abs(vr)
                    neg = vr < 0
                    m1 = mag.min(axis=1, keepdims=True)
                    at = mag == m1
                    if shape[1] >= 2:
                        # the second smallest: m1 again where it is
                        # reached twice
                        m2 = np.where(at, F32(np.inf), mag).min(
                            axis=1, keepdims=True)
                        m2 = np.where(at.sum(axis=1, keepdims=True) > 1,
                                      m1, m2)
                    else:
                        m2 = np.zeros_like(m1)
                    odd = np.logical_xor.reduce(neg, axis=1, keepdims=True)
                    bs = bss[R][:, None, :]
                    a = np.where(neg != odd, -bs, bs)
                    b = np.where(at, m2, m1)
                    new = fma32(a, b, -old[E].reshape(a.shape))
                else:
                    new = np.moveaxis(_bp(np.moveaxis(vr, 1, 2), ss[R],
                                          clamp), 2, 1) - old[E].reshape(
                                              vr.shape)
                delta[E] = new.reshape(delta[E].shape)
            if frozen:
                delta = np.where(running, delta, F32(0.0))
            new_pos = pos + delta
            flips = ((pos < 0) != (new_pos < 0)).astype(F32)
            hit = False
            for r, a0, a1 in rows:
                if a1 > a0 and flips[a0:a1].any():
                    near, cnt = nbrs[r]
                    tog = (cnt @ flips[a0:a1]).astype(np.uint8) & 1
                    was = mis[near]
                    now = was ^ tog
                    mis[near] = now
                    W += (now.sum(axis=0, dtype=np.int64)
                          - was.sum(axis=0, dtype=np.int64))
                if W.min() == 0:
                    ok = W == 0
                    n_iter[live[ok]] = it + 1
                    conv[live[ok]] = True
                    running &= ~ok
                    W[ok] += FROZEN
                    frozen = hit = True
                    # the run's later rows do not run for these shots
                    delta[a1:, ok] = F32(0.0)
                    flips[a1:, ok] = F32(0.0)
            if hit:
                new_pos = pos + delta
            np.add(old, delta, out=old)
            post[V] = new_pos
        if frozen:
            post_out[live[~running]] = post[:, ~running].T
            live, post, msg = live[running], post[:, running], msg[:, running]
            mis, W = mis[:, running], W[running]
            ss, bss = ss[:, running], bss[:, running]
    post_out[live] = post.T
    return (post_out < 0).astype(np.uint8), n_iter, conv, post_out
