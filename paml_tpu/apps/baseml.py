"""baseml: maximum likelihood for nucleotide alignments.

JAX counterpart of the reference program (src/baseml.c): same model
family and fitting capabilities, built as a single jitted objective
(pattern likelihoods + gamma mixture + closed-form/spectral P(t)) optimized
with exact autodiff gradients (replacing `ming2`'s finite differences,
src/tools.c:6595).

Multi-gene (option G) semantics follow the reference (SetPGene,
src/baseml.c:1428): Mgene=0 shared everything + free per-gene rates
`rgene`; Mgene=2 per-gene (observed) frequencies; Mgene=3 per-gene rate
parameters; Mgene=4 both; Mgene=1 fully separate analyses per gene.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace as dc_replace

import jax
import jax.numpy as jnp
import numpy as np

from ..core import pruning
from ..core.dgamma import discrete_gamma
from ..core.optim import FitResult, maximize, maximize_auto
from ..core.topology import Topology, from_treenode
from ..io import seqio, treeio
from ..models import nuc

# reference bounds: SetxBound, src/baseml.c:1458
BLEN_MIN, BLEN_MAX = 4e-6, 50.0
RATE_MIN, RATE_MAX = 1e-5, 999.0
RGENE_MIN, RGENE_MAX = 1e-4, 999.0
ALPHA_MIN, ALPHA_MAX = 0.005, 999.0


@dataclass
class BasemlSpec:
    model: str = "JC69"
    ncatG: int = 1               # >1 turns on discrete gamma
    fix_alpha: bool = True
    alpha: float = 0.0
    fix_kappa: bool = False
    kappa: float = 5.0
    Mgene: int = 0
    Malpha: bool = False         # separate alpha per gene
    clock: int = 0               # 0 none; 1 global; 2 local (rates by label)
    tipdate: bool = False        # dated tips: absolute ages + mutation rate
    tipdate_timeunit: float | None = None
    fix_rho: bool = True         # AdG rate autocorrelation (rho)
    rho: float = 0.0
    nparK: int = 0               # 1: free rates; 2: free rates + freqs
    continuous_gamma: bool = False   # basemlg: continuous-gamma rates
    nhomo: int = 0               # 1: est pi; 2: branch kappas; 3/4/5: branch pis
    cleandata: bool = False
    use_median: bool = False     # discrete-gamma median option
    getSE: bool = False
    step_matrix: np.ndarray | None = None   # REVu/UNRESTu constraints
    n_user_rates: int = 0


@dataclass
class BasemlResult:
    lnL: float
    blens: np.ndarray            # per-branch MLEs, indexed by branch node
    branch_nodes: np.ndarray
    rate_params: np.ndarray
    rgene: np.ndarray
    alpha: np.ndarray | None
    pi: np.ndarray
    np: int
    topo: Topology = None
    SEs: np.ndarray | None = None
    fit: FitResult = None
    x: np.ndarray = None


def _n_rate_params(spec: BasemlSpec) -> int:
    if spec.model in ("REVu", "UNRESTu"):
        return spec.n_user_rates
    n = nuc.N_RATE_PARAMS[spec.model]
    if spec.fix_kappa and spec.model in ("K80", "F84", "HKY85", "T92", "TN93"):
        n = 0
    return n


def make_nhomo_objective(data: seqio.PackedData, topo: Topology,
                         spec: BasemlSpec, dtype=jnp.float64):
    """Nonhomogeneous models (reference: nhomo options, src/baseml.c:1201):
    nhomo=1 one estimated pi; 2: per-branch kappas; 3 (N1): per-tip pis +
    one internal + root; 4 (N2): per-node pis; 5: label-defined pi sets.
    Each branch's Q uses the pi set of its child node, normalized to mean
    rate 1; the root set gives the root distribution, making the process
    nonstationary; the likelihood runs on the tree as given."""
    from ..core.optim import simplex_decode
    branch_nodes = topo.branch_nodes()
    nb = len(branch_nodes)
    bn = jnp.asarray(branch_nodes)
    nnode = topo.nnode
    model = spec.model
    nh = spec.nhomo
    nr1 = nuc.N_RATE_PARAMS[model] if not spec.fix_kappa else (
        nuc.N_RATE_PARAMS[model] if model in ("TN93", "REV") else 0)
    tips = jnp.asarray(data.tip_partials, dtype)
    fpatt = jnp.asarray(data.fpatt, dtype)

    # pi-set assignment per node (the set index used by the branch above
    # the node; root's set is the root distribution)
    if nh == 1:
        pi_set = np.zeros(nnode, dtype=np.int64)
        n_pi = 1
        root_set = 0
    elif nh == 2:
        pi_set = np.zeros(nnode, dtype=np.int64)
        n_pi = 0
        root_set = 0
    elif nh == 4:
        pi_set = np.arange(nnode, dtype=np.int64)
        n_pi = nnode
        root_set = int(topo.root)
    elif nh == 3:
        pi_set = np.full(nnode, topo.ns, dtype=np.int64)
        pi_set[:topo.ns] = np.arange(topo.ns)
        root_set = topo.ns + 1
        pi_set[topo.root] = root_set
        n_pi = topo.ns + 2
    elif nh == 5:
        labels = topo.labels.astype(np.int64)
        nonroot = [n for n in range(nnode) if n != topo.root]
        nbtype = int(labels[nonroot].max()) + 1
        pi_set = labels.copy()
        root_lab = int(labels[topo.root])
        if root_lab == nbtype:         # root declared as an extra set
            root_set = nbtype
            n_pi = nbtype + 1
        elif 0 <= root_lab < nbtype:   # root shares a branch set
            root_set = root_lab
            n_pi = nbtype
        else:
            root_set = nbtype
            n_pi = nbtype + 1
        pi_set[topo.root] = root_set
    else:
        raise ValueError(f"nhomo {nh}")
    # per-branch rate sets: nhomo 2 -> per-branch kappa; nhomo>=3 with
    # fix_kappa=0 -> per-branch rates; else shared
    fixk = int(spec.fix_kappa)
    if nh == 2:
        n_rate_sets = nb
        nr1 = 1
    elif nh >= 3 and fixk == 0:
        n_rate_sets = nb
    elif nh >= 3 and fixk == 2:
        n_rate_sets = int(topo.labels[[n for n in range(nnode)
                                       if n != topo.root]].max()) + 1
    else:
        n_rate_sets = 1
    nrate = nr1 * n_rate_sets
    rate_set = np.zeros(nnode, dtype=np.int64)
    if n_rate_sets == nb:
        rate_set[branch_nodes] = np.arange(nb)
    elif n_rate_sets > 1:
        rate_set = np.clip(topo.labels.astype(np.int64), 0,
                           n_rate_sets - 1)
    pi_set_j = jnp.asarray(pi_set)
    obs = np.asarray(data.base_freqs)

    def unpack(x):
        t = x[:nb]
        rates = x[nb:nb + nrate].reshape(n_rate_sets, nr1) if nrate else             jnp.full((1, max(nr1, 1)), spec.kappa, dtype)
        k = nb + nrate
        if n_pi:
            pix = x[k:k + 3 * n_pi].reshape(n_pi, 3)
            pis = jax.vmap(simplex_decode)(pix)            # [n_pi, 4]
        else:
            pis = jnp.asarray(obs, dtype)[None, :]
        return t, rates, pis

    def neg_lnl(x):
        x = x.astype(dtype)
        t, rates, pis = unpack(x)
        tfull = jnp.zeros((nnode,), dtype).at[bn].set(t)

        def branch_P(node):
            pi_b = pis[pi_set[node] if n_pi else 0]
            r_b = rates[rate_set[node] if rate_set is not None else 0]
            if model in nuc.TN93_FAMILY:
                from ..core.pmat import pmat_tn93, tn93_alphas
                a1, a2, b = tn93_alphas(model, pi_b,
                                        r_b if nr1 else [spec.kappa])
                return pmat_tn93(pi_b, a1, a2, b, tfull[node][None])[0]
            Q = nuc.build_rev_Q(r_b, pi_b)
            from ..core.pmat import pmat_rev
            return pmat_rev(Q, pi_b, tfull[node][None])[0]

        P = jnp.stack([branch_P(n) for n in range(nnode)])  # [nnode, 4, 4]
        pi_root = pis[root_set] if n_pi else jnp.asarray(obs, dtype)
        piC = pi_root[None, :]
        return -pruning.lnL(P[:, None], tips, topo, piC,
                            jnp.ones((1,), dtype), fpatt)

    t0 = np.clip(topo.blen0[branch_nodes], 0.0, BLEN_MAX)
    if not (t0 > 0).any():
        t0 = np.full(nb, 0.1)
    x0 = list(np.maximum(t0, BLEN_MIN * 2))
    bounds = [(BLEN_MIN, BLEN_MAX)] * nb
    r1 = ([spec.kappa] + [1.0] * (nr1 - 1)) if nr1 else []
    x0 += r1 * n_rate_sets
    bounds += [(RATE_MIN, RATE_MAX)] * nrate
    if n_pi:
        # start each pi set from the observed frequencies of the tips it
        # governs (the reference seeds nhomo pis from per-sequence counts,
        # src/baseml.c:1237-1247); sets with no tips start from the
        # global observed frequencies
        tipf = np.asarray(data.tip_partials, float)          # [ns, H, 4]
        fw = np.asarray(data.fpatt, float)[None, :, None]
        per_tip = (tipf / np.maximum(tipf.sum(2, keepdims=True), 1e-9)
                   * fw).sum(1)
        per_tip /= np.maximum(per_tip.sum(1, keepdims=True), 1e-9)
        for k in range(n_pi):
            members = [n for n in range(topo.ns) if pi_set[n] == k]
            pk = per_tip[members].mean(0) if members else obs
            enc = np.log(np.maximum(pk[:3], 1e-8) / max(pk[3], 1e-8))
            x0 += list(enc)
        bounds += [(-19.0, 9.0)] * (3 * n_pi)
    return neg_lnl, unpack, np.array(x0), bounds


def make_objective(data: seqio.PackedData, topo: Topology, spec: BasemlSpec,
                   dtype=jnp.float64):
    """Build (neg_lnl(x), unpack, x0, bounds).

    Parameter layout mirrors the reference (GetInitials, src/baseml.c:1149):
    [branch lengths | rgene (ngene-1) | rate params | alpha(s)].
    """
    branch_nodes = topo.branch_nodes()
    nb = len(branch_nodes)
    clock = spec.clock
    tipdate = spec.tipdate
    if clock >= 1:
        # rooted tree required; parameters are root age + node proportions
        # (reference: SetBranch, src/treesub.c:3770).  With dated tips
        # (TipDate) or '@' fossil point calibrations, ages are absolute:
        # age = AgeLow + (father - AgeLow)*x, fossil nodes fixed, and a
        # mutation-rate parameter (rate00) multiplies times (reference:
        # SetAge/GetAgeLow, src/treesub.c:3713-3766; GetBranchRate :3682;
        # AbsoluteRate/NFossils flags :3639)
        int_nonroot = [n for n in range(topo.ns, topo.nnode)
                       if n != topo.root]
        fossil = {}
        if topo.ages0 is not None:
            for n in range(topo.ns, topo.nnode):
                a = topo.ages0[n]
                if a == a and a > 0:
                    fossil[int(n)] = float(a)
        absrate = tipdate or bool(fossil)
        preorder = []
        stack = [topo.root]
        while stack:
            n = stack.pop()
            preorder.append(n)
            for c in topo.children[n]:
                if c >= topo.ns:
                    stack.append(int(c))
        agelow = np.zeros(topo.nnode)
        if tipdate:
            tip_ages_np, _tu, _young = treeio.parse_tip_dates(
                data.names, spec.tipdate_timeunit)
            agelow[:topo.ns] = tip_ages_np
        if absrate:
            for n in topo.postorder:
                agelow[n] = max(fossil.get(int(c), agelow[int(c)])
                                for c in topo.children[n] if c >= 0)
        free_int = [n for n in int_nonroot if n not in fossil]
        root_fossil = int(topo.root) in fossil
        n_time = ((0 if root_fossil else 1) + len(free_int)
                  + (1 if absrate else 0))
        labels = topo.labels
        n_rate_cls = int(labels.max()) if clock in (2, 3) else 0
    G = data.ngene if spec.Mgene != 1 else 1
    per_gene_rates = spec.Mgene >= 3 and G > 1
    per_gene_pi = spec.Mgene in (2, 4) and G > 1
    nr1 = _n_rate_params(spec)
    nrate = nr1 * (G if per_gene_rates else 1)
    nrgene = G - 1
    est_alpha = ((spec.ncatG > 1) or spec.continuous_gamma) \
        and not spec.fix_alpha
    nparK = spec.nparK
    if nparK >= 1:
        # the rate-class HMM never uses alpha/rho; the reference coerces
        # them fixed (src/baseml.c:1077).  Leaving them free would slice
        # alpha into the free-rate vector in _neg_lnl_ratehmm.
        est_alpha = False
        spec = dc_replace(spec, fix_alpha=True, fix_rho=True, rho=0.0)
    nalpha = (G if (est_alpha and spec.Malpha) else (1 if est_alpha else 0))
    adg = (not spec.fix_rho) or spec.rho > 0
    if (adg or nparK) and G > 1:
        raise ValueError("AdG/nparK rate models need a single gene")
    est_rho = adg and not spec.fix_rho

    pi_g = [nuc.model_pi(spec.model,
                         data.gene_freqs[g] if per_gene_pi else data.base_freqs)
            for g in range(G)]
    tips_g = [jnp.asarray(data.tip_partials[:, data.gene_slice(g)], dtype)
              for g in range(G)]
    fpatt_g = [jnp.asarray(data.fpatt[data.gene_slice(g)], dtype)
               for g in range(G)]
    fixed_kappa = jnp.asarray(np.atleast_1d(spec.kappa).astype(np.float64), dtype)
    step = spec.step_matrix
    if spec.continuous_gamma:
        # composite Gauss-Legendre on the gamma-CDF transform: 9 panels
        # with denser coverage of the heavy right tail reproduces the
        # reference basemlg's analytic integration to ~1e-6 lnL
        _bks = [0, .1, .3, .6, .85, .96, .995, .9995, 1 - 2e-5, 1]
        _un, _wn = np.polynomial.legendre.leggauss(16)
        _us, _ws = [], []
        for _a, _b in zip(_bks[:-1], _bks[1:]):
            _us.append((_un + 1) / 2 * (_b - _a) + _a)
            _ws.append(_wn / 2 * (_b - _a))
        cg_u = jnp.asarray(np.clip(np.concatenate(_us), 1e-12, 1 - 1e-12),
                           dtype)
        cg_w = jnp.asarray(np.concatenate(_ws), dtype)
    model = spec.model
    K = spec.ncatG
    use_median = spec.use_median
    nnode = topo.nnode
    bn = jnp.asarray(branch_nodes)

    def branch_lengths(x):
        """tfull [nnode]: branch length above each node, and #params used."""
        if clock == 0:
            tfull = jnp.zeros((nnode,), x.dtype).at[bn].set(x[:nb])
            return tfull, nb
        nroot_free = 0 if root_fossil else 1
        ages = {topo.root: (jnp.asarray(fossil[int(topo.root)], x.dtype)
                            if root_fossil else x[0])}
        prop_idx = {n: nroot_free + i for i, n in enumerate(free_int)}
        for n in preorder:
            if n == topo.root:
                continue
            if n in fossil:
                ages[n] = jnp.asarray(fossil[n], x.dtype)
            elif absrate:
                ages[n] = agelow[n] + ((ages[int(topo.parent[n])]
                                        - agelow[n]) * x[prop_idx[n]])
            else:
                ages[n] = ages[int(topo.parent[n])] * x[prop_idx[n]]
        tf = [jnp.asarray(0.0, x.dtype)] * nnode
        mu = x[nroot_free + len(free_int)] if absrate else None
        k = n_time
        if clock == 2 and n_rate_cls:
            rate_cls = jnp.concatenate([jnp.ones((1,), x.dtype),
                                        x[k:k + n_rate_cls]])
            k += n_rate_cls
        for n in range(nnode):
            if n == topo.root:
                continue
            a_par = ages[int(topo.parent[n])]
            a_n = ages.get(n, jnp.asarray(agelow[n], x.dtype))
            b = a_par - a_n
            if absrate:
                b = b * mu
            if clock == 2 and n_rate_cls:
                b = b * rate_cls[labels[n]]
            tf[n] = b
        return jnp.stack(tf), k

    def unpack(x):
        tfull, k = branch_lengths(x)
        t = tfull[bn]
        if clock == 3 and n_rate_cls:
            k += G * n_rate_cls
        rgene = jnp.concatenate([jnp.ones((1,), x.dtype), x[k:k + nrgene]])
        k += nrgene
        rates = x[k:k + nrate] if nrate else fixed_kappa
        k += nrate
        if nalpha:
            alpha = x[k:k + nalpha]
        else:
            alpha = jnp.full((1,), spec.alpha, x.dtype)
        return t, rgene, rates, alpha

    def neg_lnl(x, _tips=None, _fpatt=None):
        x = x.astype(dtype)
        t, rgene, rates, alpha = unpack(x)
        tfull, k_used = branch_lengths(x)
        if adg or nparK:
            return _neg_lnl_ratehmm(x, tfull, rates, alpha)
        tips_in = tips_g if _tips is None else {0: _tips}
        fpatt_in = fpatt_g if _fpatt is None else {0: _fpatt}
        if clock == 3 and n_rate_cls:
            # combined analysis (Yang & Yoder 2003): per-gene rates for
            # the labeled branch classes (reference: GetBranchRate
            # ClockCombined arm, src/treesub.c:3705-3707); class-0 rates
            # fold into rgene, so the reported class-j rate for gene g is
            # rgene[g] * cls[g, j] -- the same manifold as the reference's
            # absolute per-(gene, class) rates
            cls = x[k_used:k_used + G * n_rate_cls].reshape(G, n_rate_cls)
            lab_j = jnp.asarray(labels.astype(np.int64))
        total = jnp.asarray(0.0, dtype)
        for g in range(G):
            a_g = alpha[g if nalpha == G and G > 1 else 0]
            if spec.continuous_gamma:
                from ..core.dgamma import gammaincinv
                r = gammaincinv(a_g, cg_u) / a_g
                w = cg_w
            elif K > 1:
                r, w = discrete_gamma(a_g, K, use_median=use_median)
            else:
                r = jnp.ones((1,), dtype)
                w = jnp.ones((1,), dtype)
            rates_g = (rates[g * nr1:(g + 1) * nr1] if per_gene_rates
                       else rates)
            pig = jnp.asarray(pi_g[g], dtype)
            tg = tfull
            if clock == 3 and n_rate_cls:
                cfac = jnp.concatenate([jnp.ones((1,), x.dtype), cls[g]])
                tg = tfull * cfac[lab_j]
            ts = tg[:, None] * (r[None, :] * rgene[g])
            P, pi_root = nuc.pmats_for_model(model, rates_g, pig, ts, step)
            piC = jnp.broadcast_to(pi_root, (r.shape[0], 4))
            total = total + pruning.lnL(P, tips_in[g], topo, piC, w,
                                        fpatt_in[g])
        return -total

    def _neg_lnl_ratehmm(x, tfull, rates, alpha):
        """AdG rate HMM over sites, or nparK free-rate models: 1 rK,
        2 rK+fK, 3 rK+MK (doubly stochastic), 4 rK+MK free rows
        (reference: lfunAdG src/treesub.c:7447; SetParameters nparK arms
        src/baseml.c:1392-1424)."""
        from ..core.hmm import autod_gamma, hmm_lnL
        from ..core.optim import simplex_decode
        n_mk = ((K - 1) * (K - 1) if nparK == 3
                else K * (K - 1) if nparK == 4 else 0)
        n_npark = ((K - 1) + (K - 1 if nparK == 2 else 0) + n_mk
                   if nparK else 0)
        k = x.shape[0] - (1 if est_rho else 0) - (1 if est_alpha else 0) \
            - n_npark
        pig = jnp.asarray(pi_g[0], dtype)
        if nparK:
            rfree = x[k:k + K - 1]
            kk = k + K - 1
            M = None
            if nparK == 2:
                w = simplex_decode(x[kk:kk + K - 1])
            elif nparK >= 3:
                nrow = K - 1 if nparK == 3 else K
                rows = [simplex_decode(x[kk + i * (K - 1):
                                         kk + (i + 1) * (K - 1)])
                        for i in range(nrow)]
                if nparK == 3:
                    # doubly stochastic: last row = 1 - column sums
                    Mtop = jnp.stack(rows)                  # [K-1, K]
                    last = 1.0 - jnp.sum(Mtop, axis=0)
                    M = jnp.concatenate([Mtop, last[None, :]])
                    w = jnp.full((K,), 1.0 / K, dtype)
                else:
                    M = jnp.stack(rows)                     # [K, K]
                    # stationary distribution (reference: PtoPi)
                    A = (M.T - jnp.eye(K, dtype=dtype)).at[K - 1].set(1.0)
                    bvec = jnp.zeros((K,), dtype).at[K - 1].set(1.0)
                    w = jnp.linalg.solve(A, bvec)
            else:
                w = jnp.full((K,), 1.0 / K, dtype)
            rlast = (1.0 - jnp.sum(w[:K - 1] * rfree)) / w[K - 1]
            r = jnp.concatenate([rfree, jnp.maximum(rlast, 1e-6)[None]])
        else:
            a_g = alpha[0]
            rho_v = x[-1] if est_rho else jnp.asarray(spec.rho, dtype)
            r, w, M = autod_gamma(a_g, rho_v, K)
        ts = tfull[:, None] * r[None, :]
        P, pi_root = nuc.pmats_for_model(model, rates, pig, ts, step)
        piC = jnp.broadcast_to(pi_root, (K, 4))
        lnf = pruning.class_site_lnf(P, tips_g[0], topo, piC)   # [K, H]
        if nparK in (1, 2):
            # iid rate classes (reference plfun = lfundG)
            lnf_c = lnf + jnp.log(w)[:, None]
            site_ln = jax.scipy.special.logsumexp(lnf_c, axis=0)
            return -jnp.sum(fpatt_g[0] * site_ln)
        lnf_sites = lnf[:, jnp.asarray(data.site_pattern)]      # [K, L]
        return -hmm_lnL(lnf_sites, M, w)

    # initial values
    if clock >= 1:
        root0 = (agelow[topo.root] * 1.5 + 0.2) if absrate else 0.2
        x0 = ([] if root_fossil else [root0]) \
            + [0.6 + 0.3 * (i % 2) * 0.2 for i in range(len(free_int))]
        bounds = ([] if root_fossil else
                  [(agelow[topo.root] + 1e-6 if absrate else 1e-5,
                    max(50.0, agelow[topo.root] * 10))]) \
            + [(1e-6, 1 - 1e-6)] * len(free_int)
        if absrate:
            x0.append(0.1)                      # rate00 per time unit
            bounds.append((1e-5, 99.0))
        if clock == 2 and n_rate_cls:
            x0 += [1.0] * n_rate_cls
            bounds += [(1e-4, 99.0)] * n_rate_cls
        if clock == 3 and n_rate_cls:
            x0 += [1.0] * (G * n_rate_cls)
            bounds += [(1e-4, 99.0)] * (G * n_rate_cls)
    else:
        t0 = np.clip(topo.blen0[branch_nodes], 0.0, BLEN_MAX)
        if not (t0 > 0).any():
            t0 = np.full(nb, 0.1)
        t0 = np.maximum(t0, BLEN_MIN * 2)
        x0 = list(t0)
        bounds = [(BLEN_MIN, BLEN_MAX)] * nb
    x0 += [1.0] * nrgene
    bounds += [(RGENE_MIN, RGENE_MAX)] * nrgene
    r1 = {"TN93": [spec.kappa, spec.kappa]}.get(model)
    if r1 is None:
        if model in ("REV",):
            r1 = [spec.kappa] + [1.0] * 4
        elif model in ("REVu", "UNRESTu", "UNREST"):
            r1 = [1.0] * nr1
        else:
            r1 = [spec.kappa] * nr1
    x0 += r1 * (G if per_gene_rates else 1)
    bounds += [(RATE_MIN, RATE_MAX)] * nrate
    x0 += [spec.alpha if spec.alpha > 0 else 0.5] * nalpha
    bounds += [(ALPHA_MIN, ALPHA_MAX)] * nalpha
    if nparK:
        x0 += list(np.linspace(0.3, 1.5, K - 1))
        bounds += [(RATE_MIN, RATE_MAX)] * (K - 1)
        if nparK == 2:
            x0 += [0.0] * (K - 1)
            bounds += [(-19.0, 9.0)] * (K - 1)
        elif nparK in (3, 4):
            nrow = K - 1 if nparK == 3 else K
            x0 += [0.0] * (nrow * (K - 1))
            bounds += [(-19.0, 9.0)] * (nrow * (K - 1))
    if est_rho:
        x0.append(spec.rho if spec.rho > 0 else 0.3)
        bounds.append((-0.2, 0.99))
    if G == 1 and not (adg or nparK):
        # sharded-data entry point (pattern axis on a device mesh)
        neg_lnl.with_data = lambda x, t, f: neg_lnl(x, _tips=t, _fpatt=f)

        def _model0(x):
            """(P, piC, class weights, class rates) at x (single gene)."""
            x = jnp.asarray(x).astype(dtype)
            t, rgene, rates, alpha = unpack(x)
            tfull, _ = branch_lengths(x)
            if spec.continuous_gamma:
                from ..core.dgamma import gammaincinv
                r = gammaincinv(alpha[0], cg_u) / alpha[0]
                w = cg_w
            elif K > 1:
                r, w = discrete_gamma(alpha[0], K, use_median=use_median)
            else:
                r = jnp.ones((1,), dtype)
                w = jnp.ones((1,), dtype)
            pig = jnp.asarray(pi_g[0], dtype)
            ts = tfull[:, None] * r[None, :]
            P, pi_root = nuc.pmats_for_model(model, rates, pig, ts, step)
            piC = jnp.broadcast_to(pi_root, (r.shape[0], 4))
            return P, piC, w, r
        neg_lnl.model_at = _model0

        def _site_loglik(x):
            P, piC, w, _ = _model0(x)
            return pruning.site_loglik(P, tips_g[0], topo, piC, w)
        neg_lnl.site_loglik = _site_loglik

        def _class_posterior(x):
            P, piC, w, r = _model0(x)
            return pruning.site_class_posterior(P, tips_g[0], topo, piC,
                                                w), r, w
        neg_lnl.class_posterior = _class_posterior
    return neg_lnl, unpack, np.array(x0), bounds


def rho_rate(data: seqio.PackedData, topo: Topology, spec: BasemlSpec,
             x) -> dict:
    """Continuous-gamma rate factors per site pattern and the rate
    'correlation' diagnostics (reference: RhoRate, src/basemlg.c:451,
    Yang & Wang).  Returns posterior-mean rates per pattern plus the
    variance decomposition (Vr, Vr0, PEV, RHO) — the 'accurate' variant
    enumerates all 4^ns patterns when ns < 8, else uses the observed
    patterns with model weights."""
    import dataclasses

    spec_cg = dataclasses.replace(spec, continuous_gamma=True)
    neg, unpack, x0, bounds = make_objective(data, topo, spec_cg)
    xj = jnp.asarray(np.asarray(x, float))
    _, _, _, alpha_v = unpack(xj)
    alpha = float(np.asarray(alpha_v).reshape(-1)[0])
    post, r, w = neg.class_posterior(xj)
    post = np.asarray(post)
    r = np.asarray(r)
    rh = (r[:, None] * post).sum(0)                      # [H] E[r | pattern]
    lnf = np.asarray(neg.site_loglik(xj))
    fobs = np.asarray(data.fpatt, float)
    ls = fobs.sum()
    mrh0 = float((rh * fobs).sum() / ls)
    vrh0 = float((rh ** 2 * fobs).sum() / ls) - mrh0 ** 2

    ns = data.ns
    if ns < 8:
        # accurate: enumerate all 4^ns patterns
        H = 4 ** ns
        states = np.indices((4,) * ns).reshape(ns, H)
        P, piC, wq, rq = neg.model_at(xj)
        from ..core import pruning
        lnf_all = np.asarray(pruning.class_site_lnf(
            P, jnp.asarray(states.astype(np.int32)), topo, piC))
        wlog = lnf_all + np.log(np.asarray(wq))[:, None]
        m = wlog.max(0)
        fh = np.exp(m) * np.exp(wlog - m).sum(0)         # [H]
        posth = np.exp(wlog - m) / np.exp(wlog - m).sum(0)
        rh_all = (np.asarray(rq)[:, None] * posth).sum(0)
        vr = float((fh * rh_all ** 2).sum()) - 1.0
    else:
        fh = np.exp(lnf)
        vr = float((fh * rh ** 2).sum()) - 1.0
    return dict(rates=rh, lnf=lnf, alpha=alpha,
                Vr=vr, Vr0=vrh0, mrh0=mrh0,
                PEV=1.0 / alpha - vr, PEV0=1.0 / alpha - vrh0,
                RHO=math.sqrt(max(vr, 0.0) * alpha),
                RHO0=math.sqrt(max(vrh0, 0.0) * alpha))


def fit(seqfile: str, treefile: str, spec: BasemlSpec | None = None,
        tree_index: int = 0, dtype=jnp.float64) -> BasemlResult:
    spec = spec or BasemlSpec()
    aln = seqio.read_alignment(seqfile, seqio.BASE_SEQ)
    data = seqio.pack(aln, cleandata=spec.cleandata)
    trees = treeio.read_trees(treefile, data.names)
    topo = from_treenode(trees[tree_index], data.names)
    return fit_packed(data, topo, spec, dtype=dtype)


def fit_packed(data: seqio.PackedData, topo: Topology,
               spec: BasemlSpec, dtype=None) -> BasemlResult:
    from ..parallel.sharding import maybe_pad_packed
    data = maybe_pad_packed(data)
    if spec.nhomo:
        return _fit_nhomo(data, topo, spec, dtype)
    exp_dtype = dtype
    dtype = jnp.float64 if dtype is None else dtype
    neg_lnl, unpack, x0, bounds = make_objective(data, topo, spec, dtype)
    multi = None
    if spec.nparK:
        # free-rate mixtures / rate HMMs are multimodal in the rate
        # ordering and (nparK >= 3) in the transition structure
        K = spec.ncatG
        n_extra = {0: 0, 1: 0, 2: K - 1, 3: (K - 1) * (K - 1),
                   4: K * (K - 1)}[spec.nparK]
        off = len(x0) - (K - 1) - n_extra
        multi = []
        for rr in (np.linspace(0.05, 0.8, K - 1),
                   np.linspace(0.8, 3.0, K - 1),
                   np.full(K - 1, 1.0),
                   np.linspace(0.05, 3.0, K - 1)):
            s = x0.copy()
            s[off:off + K - 1] = rr
            multi.append(s)
        if spec.nparK >= 3:
            # sticky-diagonal transition start: strong rate persistence
            nrow = K - 1 if spec.nparK == 3 else K
            for rr in (np.linspace(0.05, 3.0, K - 1),
                       np.linspace(0.8, 3.0, K - 1)):
                s = x0.copy()
                s[off:off + K - 1] = rr
                mk0 = off + K - 1
                for i in range(nrow):
                    if i < K - 1:
                        s[mk0 + i * (K - 1) + i] = 2.5
                multi.append(s)
    res = maximize_auto(
        lambda dt: make_objective(data, topo, spec, dt)[0],
        neg_lnl, x0, bounds, multi_start=multi, explicit_dtype=exp_dtype)
    t, rgene, rates, alpha = unpack(jnp.asarray(res.x))
    branch_nodes = topo.branch_nodes()
    ses = None
    if spec.getSE:
        H = jax.hessian(neg_lnl)(jnp.asarray(res.x))
        cov = np.linalg.inv(np.asarray(H))
        ses = np.sqrt(np.maximum(np.diag(cov), 0.0))
    est_alpha = ((spec.ncatG > 1) or spec.continuous_gamma) \
        and not spec.fix_alpha
    return BasemlResult(
        lnL=res.lnL, blens=np.asarray(t), branch_nodes=branch_nodes,
        rate_params=np.asarray(rates), rgene=np.asarray(rgene),
        alpha=(np.asarray(alpha)
               if (spec.ncatG > 1 or spec.continuous_gamma) else None),
        pi=nuc.model_pi(spec.model, data.base_freqs),
        np=len(res.x), topo=topo, SEs=ses, fit=res, x=np.asarray(res.x))


def fit_separate(seqfile: str, treefile: str, spec: BasemlSpec,
                 dtype=jnp.float64) -> list[BasemlResult]:
    """Mgene=1: independent analysis per gene (reference: MultipleGenes,
    src/treesub.c:5170)."""
    aln = seqio.read_alignment(seqfile, seqio.BASE_SEQ)
    results = []
    for g in range(aln.ngene):
        sel = np.where(aln.site_gene == g)[0]
        sub = seqio.Alignment(aln.names, ["".join(r[i] for i in sel)
                                          for r in aln.rows], aln.seqtype)
        data = seqio.pack(sub, cleandata=spec.cleandata)
        trees = treeio.read_trees(treefile, data.names)
        topo = from_treenode(trees[0], data.names)
        import dataclasses
        results.append(fit_packed(
            data, topo, dataclasses.replace(spec, Mgene=0), dtype=dtype))
    return results


def _fit_nhomo(data, topo, spec, dtype=None):
    exp_dtype = dtype
    dtype = jnp.float64 if dtype is None else dtype
    neg_lnl, unpack, x0, bounds = make_nhomo_objective(data, topo, spec,
                                                       dtype)
    # nonhomogeneous surfaces are multimodal (per-branch pis can trade
    # against per-branch rates, with optima at simplex boundaries —
    # cf. the extreme MLEs in the reference's own examples/nhomo
    # outputs); a couple of structured extra starts guard the basin
    nb = len(topo.branch_nodes())
    multi = None
    if data.npatt * nb < 20_000:       # small problems: cheap extra starts
        multi = []
        rng = np.random.default_rng(0)
        for scale in (0.75, 1.5):
            s = x0.copy()
            s[:nb] = np.maximum(s[:nb] * scale, BLEN_MIN * 2)
            s[nb:] += rng.normal(0, 0.4, len(s) - nb)
            multi.append(s)
    res = maximize_auto(
        lambda dt: make_nhomo_objective(data, topo, spec, dt)[0],
        neg_lnl, x0, bounds, multi_start=multi, explicit_dtype=exp_dtype)
    t, rates, pis = unpack(jnp.asarray(res.x))
    return BasemlResult(
        lnL=res.lnL, blens=np.asarray(t),
        branch_nodes=topo.branch_nodes(), rate_params=np.asarray(rates),
        rgene=np.ones(1), alpha=None, pi=np.asarray(pis), np=len(res.x),
        topo=topo, SEs=None, fit=res, x=np.asarray(res.x))
