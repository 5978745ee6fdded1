"""Plain float64 Felsenstein pruning: the yardstick for core/pruning.py.

A straightforward recursion, one node at a time in postorder.  A node's
partial likelihood is the product over its children of P_child applied
to the child's partial, rescaled per (class, pattern) by its largest
entry with the log of that scale accumulated; the site log-likelihood is
a logsumexp over classes.  Gradients are plain autodiff.  This module
shares no code with core/pruning.py and nothing in the program
dispatches to it: tests and chip_smoke.py compare the production paths
against it.

Shapes follow core/pruning.py: P [nnode, C, n, n] with row = parent
state, tips [ns, H] integer states or [ns, H, n] partials, pi [C, n].
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .topology import Topology


def class_site_lnf(P, tips, topo: Topology, pi):
    """Per-(class, pattern) log site likelihood [C, H] in float64."""
    P = jnp.asarray(P, jnp.float64)
    pi = jnp.asarray(pi, jnp.float64)
    C, n = P.shape[1], P.shape[-1]
    tips = jnp.asarray(tips)
    if tips.ndim == 2:
        tips = jax.nn.one_hot(tips, n, dtype=jnp.float64)
    tips = tips.astype(jnp.float64)
    H = tips.shape[1]
    partial = {t: jnp.broadcast_to(tips[t], (C, H, n))
               for t in range(topo.ns)}
    logscale = jnp.zeros((C, H), jnp.float64)
    for v in topo.postorder:
        v = int(v)
        prod = jnp.ones((C, H, n), jnp.float64)
        for c in topo.children[v]:
            c = int(c)
            if c < 0:
                continue
            # contrib[k, h, i] = sum_j P[c, k, i, j] * L_c[k, h, j]
            prod = prod * jnp.einsum("kij,khj->khi", P[c], partial.pop(c))
        m = jax.lax.stop_gradient(jnp.max(prod, axis=-1))
        m = jnp.where(m > 0, m, 1.0)
        partial[v] = prod / m[..., None]
        logscale = logscale + jnp.log(m)
    root = partial.pop(int(topo.root))
    return jnp.log(jnp.einsum("khi,ki->kh", root, pi)) + logscale


def site_loglik(P, tips, topo: Topology, pi, class_w):
    """Per-pattern log-likelihood [H], mixing site classes."""
    lnf = class_site_lnf(P, tips, topo, pi)
    w = jnp.asarray(class_w, jnp.float64)
    return jax.scipy.special.logsumexp(lnf + jnp.log(w)[:, None], axis=0)


def lnL(P, tips, topo: Topology, pi, class_w, fpatt):
    """Total log-likelihood sum_h fpatt[h] * ln f_h."""
    fpatt = jnp.asarray(fpatt, jnp.float64)
    return jnp.sum(fpatt * site_loglik(P, tips, topo, pi, class_w))
