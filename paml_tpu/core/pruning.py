"""Felsenstein pruning: level-batched contraction with an analytic adjoint.

Replaces the reference's recursive `ConditionalPNode` (src/codeml.c:3526,
src/baseml.c:1517).  Two execution strategies share one public API:

* **Level path** (default): the tree is grouped into static depth levels at
  trace time.  Each node's upward "contribution" c_v = P_v^T s_v is emitted
  by ONE batched einsum per level (batch = nodes-in-level x classes, M =
  patterns), and a parent's partial is the pure elementwise product of its
  children's contributions followed by a per-(class, pattern) rescale — an
  always-on version of the reference's scaling machinery
  (`SetNodeScale`/`NodeScale`, src/treesub.c:7177-7227) accumulated in log
  space.  All indices are static Python ints, so XLA sees straight-line
  code with large batched matmuls and no dynamic gathers.
  All tip contributions are computed up front in a single einsum.

* **Scan path** (fallback for very deep trees, > _MAX_UNROLL levels): a
  `lax.scan` over the postorder schedule, one internal node per step.

Gradients w.r.t. P and pi use the classic inside/outside analytic adjoint
(custom VJP) in both paths: the backward pass is one downward sweep reusing
the forward's scaled partials, O(n_internal * H * n) memory.  (The same
downward pass powers marginal ancestral reconstruction, reference:
AncestralMarginal, src/treesub.c:6288.)

Shapes:
  tips:  [ns, H, n]        tip partials (state-set indicators)
  P:     [nnode, C, n, n]  transition matrices, row j = from-parent state:
                           c[h, j] = sum_i P[j, i] * s[h, i]
  pi:    [C, n]            per-class root frequencies
  out:   per-(class, pattern) log site likelihood [C, H]

Site-class mixtures (discrete gamma, NSsites) ride the C axis; the final
site log-likelihood is a logsumexp over classes (reference: `lfundG`,
src/treesub.c:7608, `fx_r` :7696).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .topology import Topology

_MAX_UNROLL = 192          # levels; beyond this fall back to lax.scan

# ---------------------------------------------------------------------------
# static schedules
# ---------------------------------------------------------------------------


def _levels(topo: Topology):
    """Group internal nodes into depth levels (children strictly below).

    Returns a list of levels; each level is a list of (node, kids-tuple).
    Level order is a valid topological order for the upward pass.
    """
    cached = getattr(topo, "_levels_cache", None)
    if cached is not None:
        return cached
    depth = np.zeros(topo.nnode, dtype=np.int64)
    kids_of = {}
    for v in topo.postorder:
        kids = tuple(int(c) for c in topo.children[v] if c >= 0)
        kids_of[int(v)] = kids
        depth[v] = 1 + max(depth[k] for k in kids)
    out = []
    for d in range(1, int(depth[topo.postorder].max()) + 1):
        lv = [(int(v), kids_of[int(v)]) for v in topo.postorder
              if depth[v] == d]
        if lv:
            out.append(lv)
    topo._levels_cache = out
    return out


def _arity_groups(level):
    """Split a level's [(node, kids)] by arity -> {K: [(node, kids)]}."""
    groups: dict[int, list] = {}
    for node, kids in level:
        groups.setdefault(len(kids), []).append((node, kids))
    return groups


def _schedule(topo: Topology) -> tuple[np.ndarray, np.ndarray]:
    nodes = topo.postorder                         # [ni]
    children = topo.children[nodes]                # [ni, K]
    return nodes.astype(np.int32), children.astype(np.int32)


# ---------------------------------------------------------------------------
# level path: forward
# ---------------------------------------------------------------------------


# Internal layout note: the level path keeps partials as [C, n, H] — the
# large pattern axis last (contiguous), so each node's contraction is a
# batched [n, n] x [n, H] product and the elementwise product/rescale
# stages stream over contiguous pattern rows.


def _is_state_tips(tips) -> bool:
    """Integer [ns, H] state codes (clean data) instead of one-hot
    [ns, H, n] partials?  State codes turn the tip einsum into a gather
    of P columns and shrink tip storage n-fold."""
    return jnp.asarray(tips).ndim == 2


def _tip_contribs(P, tipsT, topo: Topology):
    """One einsum for every tip's upward contribution: [ns, C, n, H].

    tipsT: [ns, n, H] transposed partials, or int states [ns, H]."""
    ns = topo.ns
    if _is_state_tips(tipsT):
        # ctip[t, c, j, h] = P[t, c, j, states[t, h]]
        idx = tipsT[:, None, None, :]                      # [ns,1,1,H]
        return jnp.take_along_axis(P[:ns], idx, axis=3)
    return jnp.einsum("tih,tcji->tcjh", tipsT, P[:ns])


def _forward_levels(P, tipsT, topo: Topology, want_contribs=False):
    """Upward level sweep (tipsT: [ns, n, H]).

    Returns (s, m): dicts node -> scaled partial [C, n, H] (internal nodes
    only) and node -> scale factor [C, H]; with want_contribs also the
    per-node contribution dict (backward-pass residuals)."""
    ctip = _tip_contribs(P, tipsT, topo)
    c = {t: ctip[t] for t in range(topo.ns)}
    s: dict[int, jnp.ndarray] = {}
    m: dict[int, jnp.ndarray] = {}
    for level in _levels(topo):
        emit_nodes = []
        emit_vals = []
        for K, grp in _arity_groups(level).items():
            kid_c = jnp.stack([c[k] for node, kids in grp for k in kids])
            W = len(grp)
            kid_c = kid_c.reshape((W, K) + kid_c.shape[1:])   # [W,K,C,n,H]
            prod = kid_c[:, 0]
            for k in range(1, K):
                prod = prod * kid_c[:, k]                     # [W,C,n,H]
            mm = jnp.max(prod, axis=-2)                       # [W,C,H]
            msafe = jnp.where(mm > 0, mm, 1.0)
            sv = prod / msafe[..., None, :]
            for w, (node, kids) in enumerate(grp):
                s[node] = sv[w]
                m[node] = msafe[w]
                if node != topo.root:
                    emit_nodes.append(node)
                    emit_vals.append(sv[w])
        if emit_nodes:
            S = jnp.stack(emit_vals)                          # [W,C,n,H]
            Pn = P[np.array(emit_nodes)]                      # [W,C,n,n]
            cv = jnp.einsum("wcih,wcji->wcjh", S, Pn)
            for w, node in enumerate(emit_nodes):
                c[node] = cv[w]
    if want_contribs:
        return s, m, c
    return s, m


def _tipsT_of(tips, dtype):
    if _is_state_tips(tips):
        return jnp.asarray(tips)
    return jnp.swapaxes(jnp.asarray(tips).astype(dtype), -1, -2)


@partial(jax.custom_vjp, nondiff_argnums=(2,))
def _class_site_lnf_lvl(P, tips, topo: Topology, pi):
    tipsT = _tipsT_of(tips, P.dtype)
    s, m = _forward_levels(P, tipsT, topo)
    F = jnp.einsum("cnh,cn->ch", s[topo.root], pi)
    F = jnp.maximum(F, jnp.finfo(F.dtype).tiny)
    return jnp.log(F) + jnp.sum(jnp.log(jnp.stack(list(m.values()))),
                                axis=0)


def _lnf_lvl_fwd(P, tips, topo, pi):
    tipsT = _tipsT_of(tips, P.dtype)
    s, m, c = _forward_levels(P, tipsT, topo, want_contribs=True)
    F = jnp.einsum("cnh,cn->ch", s[topo.root], pi)
    F = jnp.maximum(F, jnp.finfo(F.dtype).tiny)
    logm = jnp.sum(jnp.log(jnp.stack(list(m.values()))), axis=0)
    lnf = jnp.log(F) + logm
    return lnf, (P, tipsT, s, m, c, F, pi)


def _lnf_lvl_bwd(topo, res, gbar):
    P, tipsT, s, m, c, F, pi = res
    ns = topo.ns
    dtype = P.dtype
    C, n = P.shape[1], P.shape[3]
    state_tips = _is_state_tips(tipsT)
    H = tipsT.shape[1] if state_tips else tipsT.shape[2]
    levels = _levels(topo)

    def tip_onehotT(k):
        """[n, H] one-hot (materialized lazily for state-coded tips)."""
        if state_tips:
            return jax.nn.one_hot(tipsT[k], n, axis=0, dtype=dtype)
        return tipsT[k]

    A: dict[int, jnp.ndarray] = {
        topo.root: gbar[:, None, :] * pi[:, :, None] / F[:, None, :]}
    dP: dict[int, jnp.ndarray] = {}
    cap = 1e12
    for level in reversed(levels):
        for K, grp in _arity_groups(level).items():
            W = len(grp)
            kid_c = jnp.stack([c[k] for node, kids in grp for k in kids])
            kid_c = kid_c.reshape((W, K, C, n, H))
            # leave-one-out products over the child axis
            pre = [jnp.ones_like(kid_c[:, 0])]
            for k in range(1, K):
                pre.append(pre[-1] * kid_c[:, k - 1])
            suf = [jnp.ones_like(kid_c[:, 0])]
            for k in range(K - 2, -1, -1):
                suf.insert(0, suf[0] * kid_c[:, k + 1])
            loo = jnp.stack([pre[k] * suf[k] for k in range(K)], axis=1)
            Av = jnp.stack([A[node] for node, _ in grp])        # [W,C,n,H]
            mv = jnp.stack([m[node] for node, _ in grp])        # [W,C,H]
            G = Av[:, None] * loo / mv[:, None, :, None, :]     # [W,K,C,n,H]
            # keep the adjoint finite at absurd line-search trial points
            # (underflowed partials make 1/m overflow); gradients there are
            # garbage either way — the optimizer just needs to backtrack
            G = jnp.clip(jnp.nan_to_num(G, nan=0.0, posinf=cap,
                                        neginf=-cap), -cap, cap)
            kidflat = [k for _, kids in grp for k in kids]
            U = jnp.stack([
                (jnp.broadcast_to(tip_onehotT(k)[None], (C, n, H))
                 if k < ns else s[k]) for k in kidflat])
            U = U.reshape(W, K, C, n, H)
            dPk = jnp.einsum("wkcjh,wkcih->wkcji", G, U)
            Pk = P[np.array(kidflat)].reshape(W, K, C, n, n)
            Ak = jnp.einsum("wkcjh,wkcji->wkcih", G, Pk)
            for w, (node, kids) in enumerate(grp):
                for k, kid in enumerate(kids):
                    dP[kid] = dPk[w, k]
                    if kid >= ns:
                        A[kid] = Ak[w, k]
    zero = jnp.zeros((C, n, n), dtype)
    dP_all = jnp.stack([dP.get(v, zero) for v in range(topo.nnode)])
    dpi = jnp.einsum("ch,cnh->cn", gbar / F, s[topo.root])
    big = 1e30
    dP_all = jnp.nan_to_num(dP_all, nan=0.0, posinf=big, neginf=-big)
    dpi = jnp.nan_to_num(dpi, nan=0.0, posinf=big, neginf=-big)
    if state_tips:
        dtips = np.zeros((ns, H), dtype=jax.dtypes.float0)
    else:
        dtips = jnp.zeros((ns, H, n), tipsT.dtype)
    return dP_all, dtips, dpi


_class_site_lnf_lvl.defvjp(_lnf_lvl_fwd, _lnf_lvl_bwd)


# ---------------------------------------------------------------------------
# wide level path (large trees): static-index gather/scatter on
# consolidated buffers — O(1) ops per level instead of O(nodes), so
# tracing stays cheap for thousands of taxa
# ---------------------------------------------------------------------------

_WIDE_NNODE = 320          # switch to the wide path above this many nodes


def _wide_sched(topo: Topology):
    """Per (level, arity) static index arrays: [(nodes [W], kids [W, K])]."""
    cached = getattr(topo, "_wide_sched_cache", None)
    if cached is not None:
        return cached
    out = []
    for level in _levels(topo):
        for K, grp in _arity_groups(level).items():
            nodes = np.array([n for n, _ in grp], dtype=np.int32)
            kids = np.array([k for _, k in grp],
                            dtype=np.int32).reshape(len(grp), K)
            out.append((nodes, kids))
    topo._wide_sched_cache = out
    return out


def _forward_levels_wide(P, tipsT, topo: Topology):
    """Wide upward sweep.  Returns (SBUF [nint,C,n,H] scaled partials by
    node-ns, MBUF [nint,C,H] scale factors, logm [C,H])."""
    ns, nint, nnode = topo.ns, topo.n_internal, topo.nnode
    C, n = P.shape[1], P.shape[3]
    H = tipsT.shape[-1]
    dtype = P.dtype
    ctip = _tip_contribs(P, tipsT, topo)                    # [ns,C,n,H]
    CBUF = jnp.ones((nnode + 1, C, n, H), dtype)
    CBUF = CBUF.at[:ns].set(ctip)
    SBUF = jnp.zeros((nint, C, n, H), dtype)
    MBUF = jnp.zeros((nint, C, H), dtype)
    logm = jnp.zeros((C, H), dtype)
    for nodes, kids in _wide_sched(topo):
        U = CBUF[kids]                                      # [W,K,C,n,H]
        prod = U[:, 0]
        for k in range(1, kids.shape[1]):
            prod = prod * U[:, k]
        mm = jnp.max(prod, axis=-2)                         # [W,C,H]
        msafe = jnp.where(mm > 0, mm, 1.0)
        sv = prod / msafe[..., None, :]
        logm = logm + jnp.sum(jnp.log(msafe), axis=0)
        cv = jnp.einsum("wcih,wcji->wcjh", sv, P[nodes])
        CBUF = CBUF.at[nodes].set(cv)
        SBUF = SBUF.at[nodes - ns].set(sv)
        MBUF = MBUF.at[nodes - ns].set(msafe)
    return SBUF, MBUF, logm


@partial(jax.custom_vjp, nondiff_argnums=(2,))
def _class_site_lnf_wide(P, tips, topo: Topology, pi):
    SBUF, _, logm = _forward_levels_wide(P, _tipsT_of(tips, P.dtype), topo)
    F = jnp.einsum("cnh,cn->ch", SBUF[topo.root - topo.ns], pi)
    F = jnp.maximum(F, jnp.finfo(F.dtype).tiny)
    return jnp.log(F) + logm


def _lnf_wide_fwd(P, tips, topo, pi):
    tipsT = _tipsT_of(tips, P.dtype)
    SBUF, MBUF, logm = _forward_levels_wide(P, tipsT, topo)
    F = jnp.einsum("cnh,cn->ch", SBUF[topo.root - topo.ns], pi)
    F = jnp.maximum(F, jnp.finfo(F.dtype).tiny)
    return jnp.log(F) + logm, (P, tipsT, SBUF, MBUF, F, pi)


def _lnf_wide_bwd(topo, res, gbar):
    P, tipsT, SBUF, MBUF, F, pi = res
    ns, nint, nnode = topo.ns, topo.n_internal, topo.nnode
    C, n = P.shape[1], P.shape[3]
    dtype = P.dtype
    state_tips = _is_state_tips(tipsT)
    H = tipsT.shape[-1] if state_tips else tipsT.shape[2]
    sched = _wide_sched(topo)

    # recompute contributions: tips in one einsum; all internal non-root
    # nodes in one einsum from the stored scaled partials
    CBUF = jnp.ones((nnode + 1, C, n, H), dtype)
    CBUF = CBUF.at[:ns].set(_tip_contribs(P, tipsT, topo))
    int_nodes = np.array([v for v in range(ns, nnode) if v != topo.root],
                         dtype=np.int32)
    if len(int_nodes):
        cv = jnp.einsum("wcih,wcji->wcjh", SBUF[int_nodes - ns],
                        P[int_nodes])
        CBUF = CBUF.at[int_nodes].set(cv)

    # child partials (tips as one-hot) for the dP outer products
    if state_tips:
        tip1h = jax.nn.one_hot(tipsT, n, axis=-2, dtype=dtype)  # [ns,n,H]
    else:
        tip1h = tipsT
    UEXT = jnp.zeros((nnode + 1, C, n, H), dtype)
    UEXT = UEXT.at[:ns].set(jnp.broadcast_to(tip1h[:, None], (ns, C, n, H)))
    UEXT = UEXT.at[ns:nnode].set(SBUF)

    ABUF = jnp.zeros((nint, C, n, H), dtype)
    ABUF = ABUF.at[topo.root - ns].set(
        gbar[:, None, :] * pi[:, :, None] / F[:, None, :])
    DPBUF = jnp.zeros((nnode, C, n, n), dtype)
    cap = 1e12
    for nodes, kids in reversed(sched):
        K = kids.shape[1]
        U = CBUF[kids]                                      # [W,K,C,n,H]
        pre = [jnp.ones_like(U[:, 0])]
        for k in range(1, K):
            pre.append(pre[-1] * U[:, k - 1])
        suf = [jnp.ones_like(U[:, 0])]
        for k in range(K - 2, -1, -1):
            suf.insert(0, suf[0] * U[:, k + 1])
        loo = jnp.stack([pre[k] * suf[k] for k in range(K)], axis=1)
        Av = ABUF[nodes - ns]                               # [W,C,n,H]
        mv = MBUF[nodes - ns]                               # [W,C,H]
        G = Av[:, None] * loo / mv[:, None, :, None, :]
        G = jnp.clip(jnp.nan_to_num(G, nan=0.0, posinf=cap, neginf=-cap),
                     -cap, cap)
        Us = UEXT[kids]
        dPk = jnp.einsum("wkcjh,wkcih->wkcji", G, Us)
        DPBUF = DPBUF.at[kids].set(dPk)    # each child has one parent
        Ak = jnp.einsum("wkcjh,wkcji->wkcih", G, P[kids])
        int_kid = kids >= ns                                # static mask
        if int_kid.any():
            ABUF = ABUF.at[np.clip(kids - ns, 0, nint - 1)].add(
                jnp.where(jnp.asarray(int_kid)[:, :, None, None, None],
                          Ak, 0.0))
    dpi = jnp.einsum("ch,cnh->cn", gbar / F, SBUF[topo.root - ns])
    big = 1e30
    dP_all = jnp.nan_to_num(DPBUF, nan=0.0, posinf=big, neginf=-big)
    dpi = jnp.nan_to_num(dpi, nan=0.0, posinf=big, neginf=-big)
    if state_tips:
        dtips = np.zeros((ns, H), dtype=jax.dtypes.float0)
    else:
        dtips = jnp.zeros((ns, H, n), tipsT.dtype)
    return dP_all, dtips, dpi


_class_site_lnf_wide.defvjp(_lnf_wide_fwd, _lnf_wide_bwd)


# ---------------------------------------------------------------------------
# scan path (deep trees): one internal node per lax.scan step
# ---------------------------------------------------------------------------


def _forward_buffers(P, tips, topo: Topology):
    """Upward scan; returns (buf [nint,C,H,n] scaled partials indexed by
    node-ns, mbuf [nint,C,H] per-node scale factors in postorder order)."""
    ns, nint, nnode = topo.ns, topo.n_internal, topo.nnode
    C, n = P.shape[1], P.shape[3]
    H = tips.shape[1]
    dtype = P.dtype
    nodes, children = _schedule(topo)
    tips = jnp.asarray(tips).astype(dtype)
    buf0 = jnp.zeros((nint, C, H, n), dtype)

    def step(buf, sched):
        node, kids = sched
        valid = kids >= 0
        is_tip = (kids >= 0) & (kids < ns)
        tipvals = tips[jnp.clip(kids, 0, ns - 1)]
        intvals = buf[jnp.clip(kids - ns, 0, nint - 1)]
        part = jnp.where(is_tip[:, None, None, None],
                         tipvals[:, None, :, :], intvals)
        Pk = P[jnp.clip(kids, 0, nnode - 1)]
        contrib = jnp.einsum("kchi,kcji->kchj", part, Pk)
        contrib = jnp.where(valid[:, None, None, None], contrib, 1.0)
        # unrolled product over the (static, small) child axis: jnp.prod's
        # reduce_prod gradient divides by the inputs and NaNs on exact
        # zeros (which P = max(P, 0) clipping can produce in f32)
        prod = contrib[0]
        for k in range(1, contrib.shape[0]):
            prod = prod * contrib[k]
        m = jnp.max(prod, axis=-1)                             # [C, H]
        msafe = jnp.where(m > 0, m, 1.0)
        prod = prod / msafe[..., None]
        buf = buf.at[node - ns].set(prod)
        return buf, msafe

    buf, ms = jax.lax.scan(step, buf0, (jnp.asarray(nodes),
                                        jnp.asarray(children)))
    return buf, ms            # ms ordered by postorder position


def root_partials(P: jnp.ndarray, tips: jnp.ndarray, topo: Topology):
    """Per-class root partials [C, H, n] and per-(class, pattern) log scale
    [C, H]."""
    if len(_levels(topo)) <= _MAX_UNROLL:
        s, m = _forward_levels(P, _tipsT_of(tips, P.dtype), topo)
        logscale = sum(jnp.log(mv) for mv in m.values())
        return jnp.swapaxes(s[topo.root], -1, -2), logscale
    buf, ms = _forward_buffers(P, tips, topo)
    return buf[topo.root - topo.ns], jnp.sum(jnp.log(ms), axis=0)


@partial(jax.custom_vjp, nondiff_argnums=(2,))
def _class_site_lnf_scan(P, tips, topo: Topology, pi):
    buf, ms = _forward_buffers(P, tips, topo)
    rootp = buf[topo.root - topo.ns]
    F = jnp.einsum("chn,cn->ch", rootp, pi)
    F = jnp.maximum(F, jnp.finfo(F.dtype).tiny)
    return jnp.log(F) + jnp.sum(jnp.log(ms), axis=0)


def _lnf_scan_fwd(P, tips, topo, pi):
    buf, ms = _forward_buffers(P, tips, topo)
    rootp = buf[topo.root - topo.ns]
    F = jnp.einsum("chn,cn->ch", rootp, pi)
    F = jnp.maximum(F, jnp.finfo(F.dtype).tiny)
    lnf = jnp.log(F) + jnp.sum(jnp.log(ms), axis=0)
    return lnf, (P, tips, buf, ms, F, pi)


def _lnf_scan_bwd(topo, res, gbar):
    P, tips, buf, ms, F, pi = res
    ns, nint, nnode = topo.ns, topo.n_internal, topo.nnode
    C, n = P.shape[1], P.shape[3]
    H = tips.shape[1]
    dtype = P.dtype
    nodes, children = _schedule(topo)
    tips = tips.astype(dtype)
    rootp = buf[topo.root - topo.ns]

    # adjoint at the root: A_root = gbar * pi / F
    A0 = gbar[:, :, None] * pi[:, None, :] / F[:, :, None]       # [C, H, n]
    Abuf0 = jnp.zeros((nint, C, H, n), dtype).at[topo.root - ns].set(A0)
    dP0 = jnp.zeros_like(P)

    # reverse the postorder: parents before children
    order = np.arange(len(nodes))[::-1].copy()
    sched = (jnp.asarray(nodes[order]), jnp.asarray(children[order]),
             jnp.asarray(order))

    ms_all = ms                                                # [nint, C, H]

    def step(carry, sch):
        Abuf, dP = carry
        node, kids, post_idx = sch
        valid = kids >= 0
        is_tip = (kids >= 0) & (kids < ns)
        tipvals = tips[jnp.clip(kids, 0, ns - 1)]
        intvals = buf[jnp.clip(kids - ns, 0, nint - 1)]
        U = jnp.where(is_tip[:, None, None, None],
                      tipvals[:, None, :, :], intvals)          # [K,C,H,n]
        Pk = P[jnp.clip(kids, 0, nnode - 1)]                    # [K,C,n,n]
        c = jnp.einsum("kchi,kcji->kchj", U, Pk)
        c = jnp.where(valid[:, None, None, None], c, 1.0)
        K = c.shape[0]
        # leave-one-out products over the child axis
        pre = [jnp.ones_like(c[0])]
        for k in range(1, K):
            pre.append(pre[-1] * c[k - 1])
        suf = [jnp.ones_like(c[0])]
        for k in range(K - 2, -1, -1):
            suf.insert(0, suf[0] * c[k + 1])
        loo = jnp.stack([pre[k] * suf[k] for k in range(K)])    # [K,C,H,n]
        Ap = Abuf[node - ns]                                    # [C,H,n]
        minv = 1.0 / ms_all[post_idx]                           # [C,H]
        G = Ap[None] * loo * minv[None, :, :, None]             # [K,C,H,n]
        G = jnp.where(valid[:, None, None, None], G, 0.0)
        # keep the adjoint finite at absurd line-search trial points (see
        # level path)
        cap = 1e12
        G = jnp.clip(jnp.nan_to_num(G, nan=0.0, posinf=cap, neginf=-cap),
                     -cap, cap)
        dPk = jnp.einsum("kchj,kchi->kcji", G, U)
        dP = dP.at[jnp.clip(kids, 0, nnode - 1)].add(
            jnp.where(valid[:, None, None, None], dPk, 0.0))
        Ak = jnp.einsum("kchj,kcjn->kchn", G, Pk)
        int_kid = (kids >= ns)
        Abuf = Abuf.at[jnp.clip(kids - ns, 0, nint - 1)].add(
            jnp.where(int_kid[:, None, None, None], Ak, 0.0))
        return (Abuf, dP), None

    (Abuf, dP), _ = jax.lax.scan(step, (Abuf0, dP0), sched)
    dpi = jnp.einsum("ch,chn->cn", gbar / F, rootp)
    big = 1e30
    dP = jnp.nan_to_num(dP, nan=0.0, posinf=big, neginf=-big)
    dpi = jnp.nan_to_num(dpi, nan=0.0, posinf=big, neginf=-big)
    return dP, jnp.zeros_like(tips), dpi


_class_site_lnf_scan.defvjp(_lnf_scan_fwd, _lnf_scan_bwd)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


# Optional mesh for explicit pattern-axis partitioning.  When set (via
# set_pattern_mesh), class_site_lnf shard_maps the whole per-pattern
# computation over the mesh: P/pi replicated, tips split on the pattern
# axis, output split on the pattern axis.  Each device runs the level /
# wide / scan path on its own shard, and the fpatt-weighted sum over
# patterns becomes one psum (SURVEY.md section 2.3: DP over patterns).
_pattern_mesh = None


def set_pattern_mesh(mesh, axis: str = "data") -> None:
    """Enable (mesh, axis) shard_map execution of class_site_lnf; pass
    mesh=None to disable.  The pattern axis length must be a multiple of
    the mesh size (see parallel.sharding.pad_patterns)."""
    global _pattern_mesh
    _pattern_mesh = None if mesh is None else (mesh, axis)


def _class_site_lnf_sharded(P, tips, topo: Topology, pi):
    from jax.sharding import PartitionSpec as PS

    mesh, ax = _pattern_mesh
    tips_spec = PS(None, ax) if _is_state_tips(tips) else PS(None, ax, None)
    f = jax.shard_map(
        lambda P_, t_, pi_: _class_site_lnf_local(P_, t_, topo, pi_),
        mesh=mesh, in_specs=(PS(), tips_spec, PS()),
        out_specs=PS(None, ax), check_vma=False)
    return f(P, tips, pi)


def class_site_lnf(P, tips, topo: Topology, pi):
    """Per-(class, pattern) log site likelihood [C, H].

    tips: one-hot partials [ns, H, n] (f32/f64) or clean-data integer
    state codes [ns, H].  pi: [C, n] per-class root frequencies.
    Gradients w.r.t. P and pi via the analytic adjoint; tips are data
    (zero gradient).

    Trees up to _MAX_UNROLL levels take the level path (the wide path
    above _WIDE_NNODE nodes); deeper trees take the scan path.  Under
    set_pattern_mesh, the whole computation is shard_mapped over the
    pattern axis.
    """
    if _pattern_mesh is not None:
        mesh, _ = _pattern_mesh
        nsh = int(np.prod(mesh.devices.shape))
        batched = any(type(x).__name__ == "BatchTracer"
                      for x in (P, tips, pi))
        if (not batched and tips.shape[1] % nsh == 0):
            return _class_site_lnf_sharded(P, tips, topo, pi)
    return _class_site_lnf_local(P, tips, topo, pi)


def _class_site_lnf_local(P, tips, topo: Topology, pi):
    if len(_levels(topo)) <= _MAX_UNROLL:
        if topo.nnode > _WIDE_NNODE:
            return _class_site_lnf_wide(P, tips, topo, pi)
        return _class_site_lnf_lvl(P, tips, topo, pi)
    if _is_state_tips(tips):
        tips = jax.nn.one_hot(jnp.asarray(tips), P.shape[-1], dtype=P.dtype)
    return _class_site_lnf_scan(P, tips, topo, pi)


def site_loglik(P: jnp.ndarray, tips: jnp.ndarray, topo: Topology,
                pi: jnp.ndarray, class_w: jnp.ndarray) -> jnp.ndarray:
    """Per-pattern log-likelihood, mixing site classes.

    pi: [C, n] root frequencies per class; class_w: [C] mixture weights.
    Returns [H].
    """
    lnf_ch = class_site_lnf(P, tips, topo, pi)                  # [C, H]
    lnf_c = lnf_ch + jnp.log(class_w)[:, None]
    return jax.scipy.special.logsumexp(lnf_c, axis=0)           # [H]


def lnL(P, tips, topo, pi, class_w, fpatt) -> jnp.ndarray:
    """Total log-likelihood: sum_h fpatt[h] * ln f_h (reference: `lfun`,
    src/treesub.c:7764)."""
    lnf = site_loglik(P, tips, topo, pi, class_w)
    return jnp.sum(fpatt * lnf)


def lnL_chunked(P, tips, topo, pi, class_w, fpatt, n_chunks: int):
    """Total log-likelihood with the pattern axis processed in chunks.

    For very large (taxa x patterns) problems the full partials buffer
    (O(n_internal * C * n * H)) does not fit in device memory; this maps over H
    chunks with rematerialization so peak memory is one chunk's buffers.
    Gradients flow (the chunk forward is recomputed in the backward pass).
    H must be divisible by n_chunks (pad fpatt with zeros to round up —
    zero-weight patterns contribute nothing).
    """
    ns, H = tips.shape[0], tips.shape[1]
    assert H % n_chunks == 0, "pad patterns to a multiple of n_chunks"
    chunk = H // n_chunks
    if _is_state_tips(tips):
        tips_c = jnp.moveaxis(tips.reshape(ns, n_chunks, chunk), 1, 0)
    else:
        n = tips.shape[2]
        tips_c = jnp.moveaxis(tips.reshape(ns, n_chunks, chunk, n), 1, 0)
    fpatt_c = fpatt.reshape(n_chunks, chunk)

    @jax.checkpoint
    def one(args):
        tp, fp = args
        return lnL(P, tp, topo, pi, class_w, fp)

    vals = jax.lax.map(one, (tips_c, fpatt_c))
    return jnp.sum(vals)


def site_class_posterior(P, tips, topo, pi, class_w) -> jnp.ndarray:
    """Posterior P(class | pattern): [C, H] (NEB machinery; reference:
    lfunRates src/treesub.c:7314, lfunNSsites_rate src/codeml.c:5241)."""
    lnf_c = class_site_lnf(P, tips, topo, pi) + jnp.log(class_w)[:, None]
    return jnp.exp(lnf_c - jax.scipy.special.logsumexp(lnf_c, axis=0, keepdims=True))
