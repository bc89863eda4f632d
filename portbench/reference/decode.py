"""Normalized min-sum and tanh-product BP, plain numpy in float32, one
shot at a time in effect (shots are batched, and a shot leaves the batch
when it converges).

State: a posterior LLR per variable, starting at the channel prior
log((1 - q) / q) with q = p/3 (q in float32), and a check-to-variable
message per edge, starting at 0. An iteration visits the layers in order.
A layer's check rows read v = posterior - message on each of their edges
and compute new messages:

  MS:  new_e = beta ss (-1)^(negatives among the row's v) sgn(v_e)
               * (second smallest |v| of the row if |v_e| is the smallest,
                  else the smallest)
  BP:  t_e = tanh(v_e / 2), |t_e| at least 1e-12;
       P = running product of the row's t over its edges in ascending
           variable order, |P| at least 1e-30 after each step;
       new_e = ss log((1 + u) / (1 - u)), u = P / t_e clipped to
               +-(1 - eps)

with ss = 1 - 2 syndrome bit. Each edge then adds delta_e = new_e -
message_e to its variable's posterior. Under the layered schedule (L) the
layers are the greedy contiguous row windows in which no variable occurs
twice, so the layer's rows read the posterior as the earlier layers left it;
under flooding (F) one layer holds every row, every row reads the posterior
as the iteration found it, and a variable adds its deltas in ascending row
order. After every iteration a shot whose hard decision (posterior < 0)
reproduces its syndrome has converged after that many iterations; a shot
that never does stops at max_iter.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

F32 = np.float32


@dataclasses.dataclass(frozen=True)
class Graph:
    """The edges of H (row-major, ascending variable in a row) and, per
    variable, its edges in ascending row order (-1 padded)."""

    m: int
    n: int
    edge_row: np.ndarray
    edge_var: np.ndarray
    row_ptr: np.ndarray
    var_edges: np.ndarray

    @staticmethod
    def build(H: np.ndarray) -> "Graph":
        H = (np.asarray(H) % 2).astype(np.uint8)
        m, n = H.shape
        edge_row, edge_var = np.nonzero(H)
        row_ptr = np.zeros(m + 1, dtype=np.int64)
        np.cumsum(np.bincount(edge_row, minlength=m), out=row_ptr[1:])
        deg = np.bincount(edge_var, minlength=n)
        var_edges = np.full((n, max(1, int(deg.max(initial=0)))), -1,
                            dtype=np.int64)
        fill = np.zeros(n, dtype=np.int64)
        for e in np.argsort(edge_row * n + edge_var, kind="stable"):
            v = edge_var[e]
            var_edges[v, fill[v]] = e
            fill[v] += 1
        return Graph(m=m, n=n, edge_row=edge_row, edge_var=edge_var,
                     row_ptr=row_ptr, var_edges=var_edges)


def layer_rows(H: np.ndarray, schedule: str) -> List[np.ndarray]:
    """The rows of each layer: all rows under F; under L the greedy
    contiguous windows in which no column is touched twice."""
    H = (np.asarray(H) % 2).astype(np.int64)
    m = H.shape[0]
    if schedule == "F":
        return [np.arange(m)]
    if schedule != "L":
        raise ValueError(f"schedule F or L, got {schedule!r}")
    layers, start, used = [], 0, np.zeros(H.shape[1], dtype=np.int64)
    for r in range(m):
        if (used + H[r]).max(initial=0) > 1:
            layers.append(np.arange(start, r))
            start, used = r, np.zeros_like(used)
        used += H[r]
    layers.append(np.arange(start, m))
    return layers


@dataclasses.dataclass(frozen=True)
class _Part:
    """Rows of one degree within a layer: their edges (r, d)."""

    rows: np.ndarray
    edges: np.ndarray


def _parts(g: Graph, rows: np.ndarray) -> List[_Part]:
    deg = g.row_ptr[rows + 1] - g.row_ptr[rows]
    out = []
    for d in np.unique(deg):
        if d == 0:
            continue
        rs = rows[deg == d]
        out.append(_Part(rows=rs, edges=g.row_ptr[rs][:, None]
                         + np.arange(d)[None, :]))
    return out


def prior_llr(p: float) -> np.float32:
    q = F32(p) / F32(3.0)
    x = (F32(1.0) - q) / np.maximum(q, F32(1e-9))
    return F32(np.log(np.float64(x)))


def _ms(v: np.ndarray, ss: np.ndarray, beta: np.float32) -> np.ndarray:
    a = np.abs(v)
    neg = v < 0
    if v.shape[-1] >= 2:
        part = np.partition(a, 1, axis=-1)
        m1, m2 = part[..., 0], part[..., 1]
    else:
        m1, m2 = a[..., 0], np.zeros_like(a[..., 0])
    par = (neg.sum(axis=-1) & 1).astype(F32)
    mag = np.where(a == m1[..., None], m2[..., None], m1[..., None])
    c = (beta * ss) * (F32(1.0) - F32(2.0) * par)
    return c[..., None] * np.where(neg, -mag, mag)


def _bp(v: np.ndarray, ss: np.ndarray, clamp: np.float32) -> np.ndarray:
    t_raw = np.tanh(v * F32(0.5))
    t = np.where(t_raw < 0, F32(-1.0), F32(1.0)) * np.maximum(
        np.abs(t_raw), F32(1e-12))
    prod = np.ones(v.shape[:-1], dtype=F32)
    for k in range(v.shape[-1]):
        prod = prod * t[..., k]
        prod = np.where(prod < 0, F32(-1.0), F32(1.0)) * np.maximum(
            np.abs(prod), F32(1e-30))
    u = np.clip(prod[..., None] / t, -clamp, clamp)
    return ss[..., None] * np.log((F32(1.0) + u) / (F32(1.0) - u))


def decode(H: np.ndarray, syn: np.ndarray, p: float, kind: str,
           schedule: str, max_iter: int, beta: float = 0.75,
           eps: float = 1e-6
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Decode (B, m) 0/1 syndromes: (e_hat uint8 (B, n), n_iter int32
    (B,), converged bool (B,), posterior float32 (B, n))."""
    g = Graph.build(H)
    syn = np.asarray(syn).astype(np.uint8)
    B = syn.shape[0]
    kind = kind.upper()
    layers = []
    for rows in layer_rows(H, schedule):
        parts = _parts(g, rows)
        V = np.concatenate([g.edge_var[q.edges].ravel() for q in parts])
        # a layer in which a variable occurs twice reads a snapshot
        layers.append((parts, np.unique(V).size < V.size))
    beta32 = F32(beta)
    clamp = F32(1.0 - float(eps))
    post_out = np.empty((B, g.n), dtype=F32)
    n_iter = np.full(B, max_iter, dtype=np.int32)
    conv = np.zeros(B, dtype=bool)

    live = np.arange(B)
    post = np.full((B, g.n), prior_llr(p), dtype=F32)
    msg = np.zeros((B, g.edge_var.size), dtype=F32)
    ss = F32(1.0) - F32(2.0) * syn.astype(F32)
    for it in range(max_iter):
        if live.size == 0:
            break
        for parts, snapshot in layers:
            src = post.copy() if snapshot else post
            deltas = np.zeros_like(msg) if snapshot else None
            for part in parts:
                V = g.edge_var[part.edges]
                old = msg[:, part.edges]
                v = src[:, V] - old
                s = ss[:, part.rows]
                new = _ms(v, s, beta32) if kind == "MS" else _bp(v, s, clamp)
                delta = new - old
                msg[:, part.edges] = new
                if snapshot:
                    deltas[:, part.edges] = delta
                else:
                    post[:, V] = post[:, V] + delta
            if snapshot:
                for k in range(g.var_edges.shape[1]):
                    vs = np.nonzero(g.var_edges[:, k] >= 0)[0]
                    post[:, vs] = post[:, vs] + deltas[:, g.var_edges[vs, k]]
        cs = np.zeros((live.size, g.edge_var.size + 1), dtype=np.int64)
        np.cumsum(post[:, g.edge_var] < 0, axis=1, out=cs[:, 1:])
        par = (cs[:, g.row_ptr[1:]] - cs[:, g.row_ptr[:-1]]) & 1
        ok = (par == syn[live]).all(axis=1)
        if ok.any():
            done = live[ok]
            n_iter[done] = it + 1
            conv[done] = True
            post_out[done] = post[ok]
            keep = ~ok
            live, post, msg, ss = live[keep], post[keep], msg[keep], ss[keep]
    post_out[live] = post
    return (post_out < 0).astype(np.uint8), n_iter, conv, post_out
