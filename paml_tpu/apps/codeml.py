"""codeml: maximum likelihood for codon (and amino-acid) alignments.

JAX counterpart of the reference program (src/codeml.c).  All site
models are expressed in one unified form: an omega matrix W[branch-type,
site-class] plus class frequencies, with either per-Q normalization (M0,
branch models) or mixture normalization via per-branch-type Q factors
(NSsites / branch-site / clade models; reference: Qfactor_NS machinery,
src/codeml.c:2580-2663 and Appendix B of SURVEY.md).

Site-class likelihoods ride the class axis of the pruning engine
(reference: fhK / lfundG, src/treesub.c:7608-7760).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..core import pruning
from ..core.dgamma import betaincinv, gammaincinv
from ..core.optim import (FitResult, maximize, maximize_auto,
                          simplex_decode, simplex_encode)
from ..core.pmat import pmat_rev, pmat_rev_multi
from ..core.topology import Topology, from_treenode
from ..io import seqio, treeio
from ..models import codon as codonmod

# reference bounds (SetxBound, src/codeml.c:1583 region)
BLEN_MIN, BLEN_MAX = 4e-6, 50.0
KAPPA_MIN, KAPPA_MAX = 1e-4, 999.0
OMEGA_MIN, OMEGA_MAX = 1e-4, 999.0     # M0/branch omegas (rateb)
W_MIN, W_MAX = 1e-6, 999.0             # NSsites omegas (wb with *=0.01)
P_MIN, P_MAX = 1e-5, 0.99999           # raw proportions
PQ_MIN, PQ_MAX = 0.005, 99.0           # beta p, q
TRANS_MIN, TRANS_MAX = -99.0, 99.0     # transformed proportions

NSSITES_NONE, M1A, M2A, M3, M4, M5, M7, M8 = 0, 1, 2, 3, 4, 5, 7, 8
M6, M9, M10, M11, M12, M13 = 6, 9, 10, 11, 12, 13
M2A_REL = 22


@dataclass
class CodemlSpec:
    seqtype: int = 1             # 1 codon, 2 aa
    model: int = 0               # 0 one-ratio; 1 free-ratio; 2 branch labels
    NSsites: int = 0
    codonf: str = "F3x4"         # Fequal F1x4 F3x4 Fcodon F1x4MG F3x4MG ...
    icode: int = 0
    ncatG: int = 3               # classes for M3; beta categories for M7/M8
    fix_kappa: bool = False
    kappa: float = 2.0
    fix_omega: bool = False
    omega: float = 0.4
    Mgene: int = 0               # 0 rates; 1 separate; 2 diff pi;
                                 # 3 diff kappa; 4 all diff (codeml.ctl)
    clock: int = 0               # 0 none; 1 global; 2 local (#i labels);
                                 # '@' fossil ages give absolute rates
    fix_blength: int = 0         # 0 ignore tree lengths; 1 initials;
                                 # 2 fixed (reference codeml.c:399-403)
    aaDist: int = 0              # +-1..6 chemical distances; 7 AAClasses;
                                 # 11 FIT1, 12 FIT2 (src/codeml.c:238)
    omegaAA: str | None = None   # OmegaAA.dat path/text for aaDist = 7
    fix_alpha: bool = True
    alpha: float = 0.0
    cleandata: bool = False
    hkyREV: bool = False
    estFreq: bool = False        # ML-estimate frequency/fitness params
    getSE: bool = False
    aa_model: str = "Empirical_F"   # for seqtype=2
    aa_rate_file: str | None = None
    tipdate: bool = False        # dated tips (names end in _YYYY): clock
    tipdate_timeunit: float | None = None   # with absolute ages + rate


@dataclass
class CodemlResult:
    lnL: float
    np: int
    blens: np.ndarray
    branch_nodes: np.ndarray
    kappa: np.ndarray
    params: dict
    pi: np.ndarray
    topo: Topology = None
    fit: FitResult = None
    x: np.ndarray = None
    spec: CodemlSpec = None
    site_class_post: np.ndarray | None = None   # [C, H] NEB posteriors
    class_omegas: np.ndarray | None = None
    class_freqs: np.ndarray | None = None


def _n_btypes(topo: Topology, model: int) -> int:
    if model == 0:
        return 1
    if model == 1:
        return topo.nnode - 1          # free ratios: one per branch
    return int(topo.labels.max()) + 1


# --- NSsites class builders ------------------------------------------------

def beta_median_quantiles(p, q, K: int):
    """Raw median quantiles of beta(p, q) over K classes -- NO mean
    rescaling (reference: DiscreteNSsites, src/codeml.c:2860-2871)."""
    ys = (jnp.arange(K) + 0.5) / K
    return betaincinv(p, q, ys)


def gamma_median_quantiles(alpha, beta, K: int):
    ys = (jnp.arange(K) + 0.5) / K
    return gammaincinv(alpha, ys) / beta


def cdf_quantiles(cdf, K: int, lo=1e-7, hi=99.0, iters=70):
    """Median quantiles of an arbitrary omega distribution by bisection
    with an implicit-gradient Newton polish (reference: Quantile(CDFdN_dS)
    in DiscreteNSsites, src/codeml.c:2873-2877).  `cdf` maps an array of
    omegas to CDF values and may depend on parameters in its closure --
    the final Newton step carries exact parameter gradients."""
    p = (jnp.arange(K) + 0.5) / K

    def bis(_, lh):
        l, h = lh
        m = (l + h) / 2
        c = cdf(m)
        return jnp.where(c < p, m, l), jnp.where(c < p, h, m)

    l0 = jnp.full((K,), lo)
    h0 = jnp.full((K,), hi)
    l, h = jax.lax.fori_loop(0, iters, bis, (l0, h0))
    x = jax.lax.stop_gradient((l + h) / 2)
    for _ in range(2):
        pdf = jax.jvp(cdf, (x,), (jnp.ones_like(x),))[1]
        x = x - (cdf(x) - p) / jnp.maximum(pdf, 1e-12)
        x = jnp.clip(x, lo, hi)
    return x


def _cdf_beta(x, p, q):
    from ..core.dgamma import betainc
    return betainc(p, q, jnp.clip(x, 1e-12, 1.0 - 1e-12))


def _cdf_gamma(x, a, b):
    from jax.scipy.special import gammainc
    return gammainc(a, b * jnp.maximum(x, 0.0))


def _ndtr(x):
    return jax.scipy.stats.norm.cdf(x)


def nssites_mixture_cdf(NSsites: int, theta):
    """CDF of the continuous part of the omega distribution for models
    M6/M9-M13 (reference: CDFdN_dS, src/codeml.c:2916-2983)."""
    if NSsites == M6:          # 2gamma: p0, a1, b1, a2 (=b2)
        p0, a1, b1, a2 = theta[0], theta[1], theta[2], theta[3]
        return lambda x: (p0 * _cdf_gamma(x, a1, b1)
                          + (1 - p0) * _cdf_gamma(x, a2, a2))
    if NSsites == M9:          # beta&gamma: p0, p, q, a, b
        p0, p, q, a, b = (theta[i] for i in range(5))
        return lambda x: (p0 * _cdf_beta(x, p, q)
                          + (1 - p0) * _cdf_gamma(x, a, b))
    if NSsites == M10:         # beta&gamma+1
        p0, p, q, a, b = (theta[i] for i in range(5))
        return lambda x: jnp.where(
            x <= 1.0, p0 * _cdf_beta(x, p, q),
            p0 + (1 - p0) * _cdf_gamma(x - 1.0, a, b))
    if NSsites == M11:         # beta&normal>1: p0, p, q, mu, s
        p0, p, q, mu, s = (theta[i] for i in range(5))
        z1 = jnp.maximum(_ndtr((mu - 1.0) / s), 1e-12)
        return lambda x: jnp.where(
            x <= 1.0, p0 * _cdf_beta(x, p, q),
            p0 + (1 - p0) * (1.0 - _ndtr((mu - x) / s) / z1))
    if NSsites == M12:         # 0&2normal (continuous part): p0,p1,mu2,s1,s2
        p1, mu2, s1, s2 = theta[1], theta[2], theta[3], theta[4]
        return lambda x: (1.0
                          - p1 * _ndtr(-(x - 1.0) / s1) / _ndtr(1.0 / s1)
                          - (1 - p1) * _ndtr(-(x - mu2) / s2)
                          / jnp.maximum(_ndtr(mu2 / s2), 1e-12))
    if NSsites == M13:         # 3normal: t0, t1 (transformed), mu2,s0,s1,s2
        e0, e1 = jnp.exp(theta[0]), jnp.exp(theta[1])
        z = e0 + e1 + 1.0
        f0, f1 = e0 / z, e1 / z
        f2 = 1.0 - f0 - f1
        mu2, s0, s1, s2 = theta[2], theta[3], theta[4], theta[5]
        return lambda x: (1.0 - f0 * 2.0 * _ndtr(-x / s0)
                          - f1 * _ndtr(-(x - 1.0) / s1) / _ndtr(1.0 / s1)
                          - f2 * _ndtr(-(x - mu2) / s2)
                          / jnp.maximum(_ndtr(mu2 / s2), 1e-12))
    raise ValueError(f"NSsites {NSsites}")


def nssites_nparams(NSsites: int, ncatG: int, fix_omega: bool) -> int:
    """Number of distribution parameters after kappa (excluding M0 omega)."""
    if NSsites == M1A:
        return 2                       # p0, w0
    if NSsites in (M2A, M2A_REL):
        return 3 + (0 if fix_omega else 1)   # p0, p1 (transformed), w0, [w2]
    if NSsites == M3:
        return (ncatG - 1) + ncatG
    if NSsites == M4:
        return ncatG - 1               # freqs model: fixed omegas
    if NSsites == M5:
        return 2                       # alpha, beta
    if NSsites == M7:
        return 2                       # p, q
    if NSsites == M8:
        return 3 + (0 if fix_omega else 1)   # p0, p, q, [ws]
    if NSsites == M6:
        return 4                       # p0, a1, b1, a2
    if NSsites in (M9, M10, M11, M12):
        return 5
    if NSsites == M13:
        return 6
    raise ValueError(f"NSsites {NSsites} not supported yet")


def nssites_classes(NSsites: int, theta, ncatG: int, fix_omega: bool,
                    omega_fix: float, dtype=jnp.float64):
    """(omegas [K], freqs [K]) from the distribution parameter vector."""
    if NSsites == M1A:
        p0, w0 = theta[0], theta[1]
        return (jnp.stack([w0, jnp.asarray(1.0, dtype)]),
                jnp.stack([p0, 1.0 - p0]))
    if NSsites in (M2A, M2A_REL):
        p = simplex_decode(theta[:2])
        w0 = theta[2]
        w2 = jnp.asarray(omega_fix, dtype) if fix_omega else theta[3]
        return jnp.stack([w0, jnp.asarray(1.0, dtype), w2]), p
    if NSsites == M3:
        p = simplex_decode(theta[:ncatG - 1])
        return theta[ncatG - 1:ncatG - 1 + ncatG], p
    if NSsites == M4:
        p = simplex_decode(theta[:ncatG - 1])
        w = jnp.asarray([0.0, 1 / 3, 2 / 3, 1.0, 3.0], dtype)
        return w, p
    if NSsites == M5:
        a, b = theta[0], theta[1]
        w = gamma_median_quantiles(a, b, ncatG)
        return w, jnp.full((ncatG,), 1.0 / ncatG, dtype)
    if NSsites == M7:
        w = beta_median_quantiles(theta[0], theta[1], ncatG)
        return w, jnp.full((ncatG,), 1.0 / ncatG, dtype)
    if NSsites == M8:
        p0 = theta[0]
        w = beta_median_quantiles(theta[1], theta[2], ncatG)
        ws = jnp.asarray(omega_fix, dtype) if fix_omega else theta[3]
        omegas = jnp.concatenate([w, ws[None]])
        freqs = jnp.concatenate([jnp.full((ncatG,), 1.0 / ncatG, dtype) * p0,
                                 (1.0 - p0)[None]])
        return omegas, freqs
    if NSsites in (M6, M9, M10, M11):
        cdf = nssites_mixture_cdf(NSsites, theta)
        w = cdf_quantiles(cdf, ncatG)
        return w, jnp.full((ncatG,), 1.0 / ncatG, dtype)
    if NSsites == M12:
        # spike at 0 (freq p0) + ncatG-1 classes from the 2-normal mixture
        # (reference: DiscreteNSsites NS02normal shift, src/codeml.c:2888)
        p0 = theta[0]
        K = ncatG - 1
        cdf = nssites_mixture_cdf(NSsites, theta)
        wc = cdf_quantiles(cdf, K)
        w = jnp.concatenate([jnp.zeros((1,), dtype), wc])
        freqs = jnp.concatenate([p0[None],
                                 jnp.full((K,), 1.0 / K, dtype) * (1 - p0)])
        return w, freqs
    if NSsites == M13:
        cdf = nssites_mixture_cdf(NSsites, theta)
        w = cdf_quantiles(cdf, ncatG)
        return w, jnp.full((ncatG,), 1.0 / ncatG, dtype)
    raise ValueError(f"NSsites {NSsites}")


def nssites_x0_bounds(NSsites: int, ncatG: int, fix_omega: bool,
                      omega0: float):
    if NSsites == M1A:
        return [0.7, 0.2], [(P_MIN, P_MAX), (W_MIN, 1.0)]
    if NSsites in (M2A, M2A_REL):
        x0 = [1.0, 0.5, 0.2]
        b = [(TRANS_MIN, TRANS_MAX)] * 2 + [(W_MIN, 1.0)]
        if not fix_omega:
            x0.append(max(2.0, omega0))
            b.append((1.0 if NSsites == M2A else W_MIN, W_MAX))
        return x0, b
    if NSsites == M3:
        x0 = [0.0] * (ncatG - 1) + list(np.linspace(0.1, 1.2, ncatG))
        return x0, ([(TRANS_MIN, TRANS_MAX)] * (ncatG - 1)
                    + [(W_MIN, W_MAX)] * ncatG)
    if NSsites == M4:
        return [0.0] * (ncatG - 1), [(TRANS_MIN, TRANS_MAX)] * (ncatG - 1)
    if NSsites == M5:
        return [0.6, 1.0], [(0.02, 49.0)] * 2
    if NSsites == M7:
        return [0.5, 1.2], [(PQ_MIN, PQ_MAX)] * 2
    if NSsites == M8:
        x0 = [0.9, 0.5, 1.2]
        b = [(P_MIN, P_MAX), (PQ_MIN, PQ_MAX), (PQ_MIN, PQ_MAX)]
        if not fix_omega:
            x0.append(2.0)
            b.append((1.0, W_MAX))
        return x0, b
    # reference initials/bounds: GetInitialsNSsites/SetxBound,
    # src/codeml.c:2277-2313/:1980-2013
    if NSsites == M6:
        return ([0.5, 1.0, 1.1, 1.2],
                [(P_MIN, P_MAX)] + [(0.02, 49.0)] * 3)
    if NSsites == M9:
        return ([0.9, 0.4, 1.2, 1.1, 1.1],
                [(P_MIN, P_MAX)] + [(PQ_MIN, PQ_MAX)] * 4)
    if NSsites == M10:
        return ([0.9, 0.4, 1.2, 0.1, 1.1],
                [(P_MIN, P_MAX)] + [(PQ_MIN, PQ_MAX)] * 4)
    if NSsites == M11:
        return ([0.95, 0.4, 1.2, 1.1, 1.1],
                [(P_MIN, P_MAX)] + [(PQ_MIN, PQ_MAX)] * 2
                + [(1.0, 9.0), (PQ_MIN, PQ_MAX)])
    if NSsites == M12:
        return ([0.8, 0.3, 0.2, 5.0, 1.1],
                [(P_MIN, P_MAX)] * 2 + [(1e-4, 29.0)] * 3)
    if NSsites == M13:
        return ([0.77, 0.22, 0.2, 0.5, 5.0, 1.1],
                [(-49.0, 49.0)] * 2 + [(1e-4, 29.0)] * 4)
    raise ValueError(f"NSsites {NSsites}")


# --- objective -------------------------------------------------------------

def nssites_extra_starts(NSsites: int, ncatG: int, fix_omega: bool):
    """Additional theta starting points for multimodal NSsites surfaces
    (the reference relies on users re-running with different initials;
    we build the multi-start in)."""
    if NSsites == M3:
        outs = []
        for ws in ([0.01, 0.2, 0.9], [0.05, 0.5, 3.0], [0.3, 1.0, 5.0]):
            w = list(np.linspace(ws[0], ws[-1], ncatG)) if ncatG != 3 else list(ws)
            outs.append([0.0] * (ncatG - 1) + w)
        return outs
    if NSsites in (M2A, M2A_REL):
        out = [[2.0, 0.3, 0.05], [0.0, -1.0, 0.5]]
        if not fix_omega:
            out = [o + [w2] for o, w2 in zip(out, [5.0, 1.5])]
        return out
    if NSsites == M8:
        out = [[0.99, 0.2, 1.0], [0.7, 1.0, 2.0]]
        if not fix_omega:
            out = [o + [w2] for o, w2 in zip(out, [3.0, 1.3])]
        return out
    if NSsites == M7:
        return [[0.2, 0.8], [2.0, 2.0]]
    if NSsites == M1A:
        return [[0.9, 0.05]]
    if NSsites == M5:
        return [[1.1, 1.1]]
    if NSsites == M6:
        return [[0.9, 0.5, 0.6, 2.0], [0.2, 2.0, 2.0, 0.5]]
    if NSsites == M9:
        return [[0.5, 1.0, 2.0, 0.5, 0.5]]
    if NSsites == M10:
        return [[0.5, 1.0, 2.0, 0.5, 1.0]]
    if NSsites == M11:
        return [[0.7, 0.3, 1.5, 1.5, 0.5]]
    if NSsites == M12:
        return [[0.3, 0.7, 1.5, 1.0, 0.5]]
    if NSsites == M13:
        return [[0.0, 0.0, 1.5, 1.0, 1.0, 0.5]]
    return []


def _select_branch_type(P_all, btype, B: int):
    """P[v] = P_all[v, btype[v]] with btype STATIC (tree labels).

    With static branch types a masked sum over the (small) B axis or
    static slices replace a dynamic gather over [nnode, B, K, n, n]
    operands: they compile in milliseconds and cost nothing at runtime."""
    btype = np.asarray(btype)
    if B == 1:
        return P_all[:, 0]
    if B <= 8:
        out = None
        for b in range(B):
            m = jnp.asarray((btype == b).reshape(
                (-1,) + (1,) * (P_all.ndim - 2)))
            term = jnp.where(m, P_all[:, b], 0.0)
            out = term if out is None else out + term
        return out
    # one P per branch (model=1 free omegas): static per-node slices
    return jnp.stack([P_all[v, int(btype[v])] for v in range(P_all.shape[0])])


def make_codon_objective(data: seqio.PackedData, topo: Topology,
                         spec: CodemlSpec, dtype=jnp.float64,
                         n_chunks: int = 1):
    graph = codonmod.codon_graph(spec.icode)
    fcodon, f3x4, f1x4 = codonmod.count_codon_freqs(
        data.tip_partials, data.fpatt, graph, data.pos_masks)
    pi_np = codonmod.codon_pi(spec.codonf, fcodon, f3x4, f1x4, graph)
    pf3x4 = codonmod.mg_pf3x4(spec.codonf, f3x4, f1x4)
    pi = jnp.asarray(pi_np, dtype)
    tips_np = np.asarray(data.tip_partials)
    if tips_np.ndim == 3 and tips_np.shape[0] and \
            (tips_np.sum(-1) == 1).all() and tips_np.max() == 1:
        # fully resolved one-hot data: compress to integer state codes
        # (n-fold smaller tip storage; pruning gathers P columns directly)
        tips_np = tips_np.argmax(-1).astype(np.int32)
    tips = (jnp.asarray(tips_np) if tips_np.ndim == 2
            else jnp.asarray(tips_np, dtype))
    fpatt = jnp.asarray(data.fpatt, dtype)

    branch_nodes = topo.branch_nodes()
    nb = len(branch_nodes)
    bn = jnp.asarray(branch_nodes)
    nnode = topo.nnode
    B = _n_btypes(topo, spec.model)
    NS = spec.NSsites
    ncatG = spec.ncatG
    nkappa = 0 if spec.fix_kappa else (5 if spec.hkyREV else 1)

    # clock >= 1: branch lengths come from node ages (reference: SetBranch
    # src/treesub.c:3770; '@' fossils give absolute rates)
    if spec.clock >= 1:
        from ..core.clockparam import make_clock_times
        tip_ages = None
        if spec.tipdate:
            # dated tips (reference: GetTipDate, src/treesub.c:3552):
            # ages from sequence-name suffixes; absolute-rate clock
            ta, _tu, _young = treeio.parse_tip_dates(
                data.names, spec.tipdate_timeunit)
            tip_ages = ta
        clock_fn, n_time, xt0, tbounds, _cinfo = make_clock_times(
            topo, spec.clock, tip_ages)
    elif spec.fix_blength == 2:
        n_time = 0               # branch lengths fixed at the tree's values
    else:
        n_time = nb

    # FMutSel/FMutSel0 frequency parameters (reference: com.npi,
    # src/codeml.c:1576-1588): 3 mutation-bias pi_TCA ratios, plus with
    # estFreq the fitness parameters (60 codon / 19 aa, last fixed at 0)
    is_fmutsel = spec.codonf in ("FMutSel", "FMutSel0")
    nfit = 0
    if is_fmutsel and spec.estFreq:
        nfit = 19 if spec.codonf == "FMutSel0" else graph.n - 1
    npi = (3 + nfit) if is_fmutsel else 0

    # branch type per node (root entry unused)
    if spec.model == 1:
        btype = np.zeros(nnode, dtype=np.int64)
        btype[branch_nodes] = np.arange(nb)
    else:
        btype = topo.labels.astype(np.int64)
    btype_j = jnp.asarray(btype)

    if NS == 0:
        n_theta = 0
        if spec.model == 0:
            n_w = 0 if spec.fix_omega else 1
        else:
            n_w = B - 1 if spec.fix_omega else B
    elif spec.model == 2:
        # branch-site A (NS=2): p0,p1 (transformed), w0, [w2]; B (NS=3):
        # p0,p1, w0,w1,w2
        n_theta = (3 + (0 if spec.fix_omega else 1)) if NS == M2A else 5
        n_w = 0
    elif spec.model == 3:
        # clade C (NS=2): p0,p1, w0, w2..w_{2+B-1}; D (NS=3): (ncatG-1)
        # transformed p's, ncatG-1 shared w's, B clade w's
        n_theta = ((3 + B) if NS == M2A
                   else (ncatG - 1) + (ncatG - 1) + B)
        n_w = 0
    else:
        n_theta = nssites_nparams(NS, ncatG, spec.fix_omega)
        n_w = 0

    def unpack(x):
        t = x[:n_time]
        k = n_time
        kappa = x[k:k + nkappa] if nkappa else jnp.asarray(
            [spec.kappa] * (5 if spec.hkyREV else 1), dtype)
        k += nkappa
        ppi = x[k:k + npi]
        k += npi
        theta = x[k:k + n_theta + n_w]
        return t, kappa, ppi, theta

    def classes_for(theta):
        """Build W [B, K], freqs [K], and per-branch-type scale mode."""
        if NS == 0:
            if spec.model == 0:
                w = (jnp.asarray(spec.omega, dtype) if spec.fix_omega
                     else theta[0])
                W = w.reshape(1, 1)
            else:
                ws = theta[:n_w]
                if spec.fix_omega:
                    # last branch type has the fixed omega
                    ws = jnp.concatenate(
                        [ws, jnp.asarray([spec.omega], dtype)])
                W = ws.reshape(B, 1)
            freqs = jnp.ones((1,), dtype)
            return W, freqs, "per_Q"
        if spec.model == 0:
            omegas, freqs = nssites_classes(NS, theta, ncatG, spec.fix_omega,
                                            spec.omega, dtype)
            return omegas.reshape(1, -1), freqs, "mixture"
        if spec.model == 2 and NS in (M2A, M3):
            # branch-site models A (NSsites=2) & B (NSsites=3)
            if NS == M2A:
                p = simplex_decode(theta[:2])   # p0, p1 renormalized
                w0 = theta[2]
                w2 = (jnp.asarray(spec.omega, dtype) if spec.fix_omega
                      else theta[3])
                one = jnp.asarray(1.0, dtype)
            else:
                p = simplex_decode(theta[:2])
                w0, one, w2 = theta[2], theta[3], theta[4]
            t01 = p[0] + p[1]
            freqs = jnp.stack([p[0], p[1],
                               (1 - t01) * p[0] / t01,
                               (1 - t01) * p[1] / t01])
            # rows: branch type 0 = background, 1 = foreground
            Wback = jnp.stack([w0, one, w0, one])
            Wfore = jnp.stack([w0, one, w2, w2])
            W = jnp.stack([Wback, Wfore])
            return W, freqs, "mixture"
        if spec.model == 3 and NS in (M2A, M3):
            # clade models C (NSsites=2) and D (NSsites=3)
            p = simplex_decode(theta[:ncatG - 1]) if NS == M3 else \
                simplex_decode(theta[:2])
            K = 3 if NS == M2A else ncatG
            if NS == M2A:      # model C: w0, 1, w_b per clade
                w0 = theta[2]
                base = [w0, jnp.asarray(1.0, dtype)]
                per_type = theta[3:3 + B]
            else:              # model D: w0..w_{K-2} shared, w_{K-1} per clade
                base = [theta[(K - 1) + i] for i in range(K - 1)]
                per_type = theta[(K - 1) + (K - 1):(K - 1) + (K - 1) + B]
            rows = []
            for b in range(B):
                rows.append(jnp.stack(base + [per_type[b]]))
            W = jnp.stack(rows)
            return W, p, "mixture"
        raise ValueError(f"model {spec.model} with NSsites {NS}")

    def model_at(x):
        """P [nnode, K, n, n], root freqs per class [K, n], class weights
        [K] at parameter vector x."""
        x = x.astype(dtype)
        t, kappa, ppi, theta = unpack(x)
        W, freqs, scale_mode = classes_for(theta)
        Bc, K = W.shape
        if is_fmutsel:
            pf = jnp.concatenate([ppi[:3], jnp.ones((1,), dtype)])
            pf = pf / jnp.sum(pf)
            fit = ppi[3:] if nfit else None
            pi_d = codonmod.fmutsel_pi(spec.codonf, pf, fit, fcodon,
                                       graph, dtype)
            pf3x4_d = jnp.tile(pf[None, :], (3, 1))
            s = codonmod.mutation_part(
                graph, kappa if spec.hkyREV else kappa[0], pf3x4_d,
                spec.hkyREV, dtype)
            s = s * codonmod.fmutsel_multiplier(graph, pf, pi_d, data.ls,
                                                dtype)
            rs, ra = codonmod.flux(graph, s, pi_d)
            w_flat = W.reshape(-1)                          # [B*K]
            Qs = jax.vmap(
                lambda w: codonmod.build_Q(graph, s, w, pi_d))(w_flat)
        else:
            # dense scatter-free Q build (pure elementwise + one [3,4]
            # gather per eval)
            pi_d = pi
            s_d = codonmod.mutation_dense(
                graph, kappa if spec.hkyREV else kappa[0], pf3x4,
                spec.hkyREV, dtype)
            rs, ra = codonmod.flux_dense(graph, s_d, pi_d)
            w_flat = W.reshape(-1)                          # [B*K]
            Qs = jax.vmap(
                lambda w: codonmod.build_Q_dense(graph, s_d, w, pi_d))(
                    w_flat)
        if scale_mode == "per_Q":
            scale_flat = 1.0 / (rs + ra * w_flat)           # [B*K]
        else:
            wbar = jnp.sum(W * freqs[None, :], axis=1)      # [B]
            scale_flat = jnp.repeat(1.0 / (rs + ra * wbar), K)
        if spec.clock >= 1:
            tfull = clock_fn(t)
        elif spec.fix_blength == 2:
            tfull = jnp.asarray(topo.blen0, dtype)
        else:
            tfull = jnp.zeros((nnode,), dtype).at[bn].set(t)
        # ts[node, b*k] = t[node] * scale[b*k]
        ts = tfull[:, None] * scale_flat[None, :]           # [nnode, B*K]
        P_all = pmat_rev_multi(
            Qs, pi_d, ts)                                   # [nnode, B*K, n, n]
        P_all = P_all.reshape(nnode, Bc, K, graph.n, graph.n)
        P = _select_branch_type(P_all, btype, Bc)           # [nnode, K, n, n]
        piC = jnp.broadcast_to(pi_d, (K, graph.n))
        return P, piC, freqs

    def neg_lnl_data(x, tips_a, fpatt_a):
        """Objective with the data as explicit arguments (for sharded /
        multi-device execution where tips/fpatt carry shardings)."""
        P, piC, freqs = model_at(x)
        if n_chunks > 1:
            return -pruning.lnL_chunked(P, tips_a, topo, piC, freqs,
                                        fpatt_a, n_chunks)
        return -pruning.lnL(P, tips_a, topo, piC, freqs, fpatt_a)

    def neg_lnl(x):
        return neg_lnl_data(x, tips, fpatt)
    neg_lnl.with_data = neg_lnl_data
    neg_lnl.model_at = model_at

    def site_loglik_fn(x):
        """Per-pattern log site likelihood [H] at x (for the lnf file /
        RELL; reference: print_lnf_site, src/treesub.c:7597)."""
        P, piC, freqs = model_at(x)
        return pruning.site_loglik(P, tips, topo, piC, freqs)
    neg_lnl.site_loglik = site_loglik_fn

    def class_posterior_fn(x):
        """Posterior P(class | pattern) [K, H] at x (NEB; reference:
        lfunNSsites_rate, src/codeml.c:5241)."""
        P, piC, freqs = model_at(x)
        return pruning.site_class_posterior(P, tips, topo, piC, freqs)
    neg_lnl.class_posterior = class_posterior_fn

    # x0 / bounds
    if spec.clock >= 1:
        x0 = list(xt0)
        bounds = list(tbounds)
    elif spec.fix_blength == 2:
        x0 = []
        bounds = []
    else:
        t0 = np.clip(topo.blen0[branch_nodes], 0.0, BLEN_MAX)
        if not (t0 > 0).any():
            t0 = np.full(nb, 0.1)
        t0 = np.maximum(t0, BLEN_MIN * 2)
        x0 = list(t0)
        bounds = [(BLEN_MIN, BLEN_MAX)] * nb
    if nkappa:
        x0 += [spec.kappa] * nkappa
        bounds += [(KAPPA_MIN, KAPPA_MAX)] * nkappa
    if is_fmutsel:
        # pi_TCA ratios to pi_G (reference initials, src/codeml.c:2108-2110)
        x0 += list(np.asarray(f1x4[:3]) / max(float(f1x4[3]), 1e-6))
        bounds += [(OMEGA_MIN, OMEGA_MAX)] * 3     # rateb, SetxBound default
        if nfit:
            if spec.codonf == "FMutSel0":
                piAA = codonmod.observed_piAA(fcodon, graph)
                nsyn = np.bincount(graph.aa, minlength=20).astype(float)
                x0 += list(np.log((piAA[:19] / nsyn[:19] + 1e-3)
                                  / (piAA[19] / nsyn[19] + 1e-3)))
            else:
                x0 += list(np.log((np.asarray(fcodon[:-1]) + 1e-3)
                                  / (float(fcodon[-1]) + 1e-3)))
            bounds += [(-29.0, 29.0)] * nfit       # codeml.c:1925-1927
    if NS == 0:
        x0 += [spec.omega] * n_w
        bounds += [(OMEGA_MIN, OMEGA_MAX)] * n_w
    elif spec.model == 0:
        th0, thb = nssites_x0_bounds(NS, ncatG, spec.fix_omega, spec.omega)
        x0 += th0
        bounds += thb
    elif spec.model == 2:   # branch-site A / B
        if NS == M2A:
            x0 += [1.0, 0.5, 0.2]
            bounds += [(TRANS_MIN, TRANS_MAX)] * 2 + [(W_MIN, 1.0)]
            if not spec.fix_omega:
                x0 += [2.0]
                bounds += [(1.0, W_MAX)]
        else:
            x0 += [1.0, 0.5, 0.2, 0.8, 2.0]
            bounds += [(TRANS_MIN, TRANS_MAX)] * 2 + [(W_MIN, W_MAX)] * 3
    elif spec.model == 3:
        if NS == M2A:   # clade C
            x0 += [1.0, 0.5, 0.2] + [1.0] * B
            bounds += ([(TRANS_MIN, TRANS_MAX)] * 2 + [(W_MIN, 1.0)]
                       + [(W_MIN, W_MAX)] * B)
        else:           # clade D
            x0 += [0.0] * (ncatG - 1) + [0.2, 0.8] + [1.0] * B
            bounds += ([(TRANS_MIN, TRANS_MAX)] * (ncatG - 1)
                       + [(1e-4, 1.0), (0.01, 1.5)] + [(W_MIN, W_MAX)] * B)
    return neg_lnl, unpack, classes_for, np.array(x0), bounds, pi_np


# --- aaDist / AAClasses / fitness models ------------------------------------

AACHEM_P = np.array([8.1, 10.5, 11.6, 13, 5.5, 10.5, 12.3, 9, 10.4, 5.2,
                     4.9, 11.3, 5.7, 5.2, 8, 9.2, 8.6, 5.4, 6.2, 5.9]) / 13.0
AACHEM_V = np.array([31, 124, 56, 54, 55, 85, 83, 3, 96, 111,
                     111, 119, 105, 132, 32.5, 32, 61, 170, 136, 84]) / 170.0
# (reference: AAchem p & v rows normalized by the max, src/codeml.c:201,
#  :1632-1634)

AADIST_FILES = {1: "grantham", 2: "miyata", 3: "g1974c", 4: "g1974p",
                5: "g1974v", 6: "g1974a"}


def parse_omega_aa(text: str, graph) -> np.ndarray:
    """Parse OmegaAA.dat (reference: GetOmegaAA, src/codeml.c:4079):
    returns (n_omega, class index per aa pair [20, 20]).  Class 0 is the
    background.

    The reference parses the file as a *stream*: the first integer is the
    number of omega classes ncls; exactly ncls-1 class lines follow, each
    `i: PAIRS...`, and NOTHING after them is read (the trailing `0: all
    others` line and any commentary after `// End of File` are never
    consumed).  An out-of-range ncls (<1 or >64, e.g. -1) selects the
    general model: one independent omega per one-step aa pair."""
    from ..constants import AA_ORDER
    one_step = np.zeros((20, 20), dtype=bool)
    aa_i = graph.aa[graph.pi_idx]
    aa_j = graph.aa[graph.pj_idx]
    ns = aa_i != aa_j
    one_step[aa_i[ns], aa_j[ns]] = True
    one_step |= one_step.T
    import re as _re
    int_re = _re.compile(r"\s*(-?\d+)")

    def read_int(pos):
        m = int_re.match(text, pos)
        if not m:
            raise ValueError("OmegaAA.dat: expected an integer")
        return int(m.group(1)), m.end()

    ncls, pos = read_int(0)
    cls = np.zeros((20, 20), dtype=np.int64)
    if ncls < 1 or ncls > 64:         # general model: one w per 1-step pair
        k = 0
        for i in range(20):
            for j in range(i):
                if one_step[i, j]:
                    cls[i, j] = cls[j, i] = k
                    k += 1
        return k, cls
    for iomega in range(1, ncls):     # file declares classes 1..ncls-1
        j, pos = read_int(pos)
        if j != iomega:
            raise ValueError(
                f"err data file OmegaAA.dat: expected class {iomega}, "
                f"got {j}")
        if pos >= len(text) or text[pos] != ":":
            raise ValueError("OmegaAA.dat: expected ':' after class number")
        pos += 1
        eol = text.find("\n", pos)
        line = text[pos:] if eol < 0 else text[pos:eol]
        pos = len(text) if eol < 0 else eol + 1
        i = 0
        while i < len(line):
            if not line[i].isalpha():
                i += 1
                continue
            if i + 1 >= len(line) or not line[i + 1].isalpha():
                raise ValueError("OmegaAA.dat: dangling aa in pair")
            try:
                a = AA_ORDER.index(line[i].upper())
                b = AA_ORDER.index(line[i + 1].upper())
            except ValueError:
                raise ValueError(
                    f"OmegaAA.dat: aa not found in pair {line[i:i+2]!r}")
            i += 2
            if a == b:
                continue              # "This pair has no effect"
            if not one_step[a, b]:
                continue              # unreachable in one step: ignored
            if cls[a, b]:
                raise ValueError(
                    f"OmegaAA.dat: pair {line[i-2:i]!r} already specified")
            cls[a, b] = cls[b, a] = iomega
    return ncls, cls


def make_aadist_objective(data: seqio.PackedData, topo: Topology,
                          spec: CodemlSpec, dtype=jnp.float64):
    """Objective for aaDist models (reference: GetOmega, src/codeml.c:3020):
    +-1..6 chemical-distance omegas w = b*exp(-a*d) (geometric, +) or
    b*(1-a*d) (linear, -); 7 = AAClasses (per-pair omega classes from
    OmegaAA.dat, optionally crossed with branch types under model=2);
    11/12 = FIT1/FIT2 fitness models (Yang et al. 1998)."""
    from ..models import aa as aamod
    graph = codonmod.codon_graph(spec.icode)
    fcodon, f3x4, f1x4 = codonmod.count_codon_freqs(
        data.tip_partials, data.fpatt, graph, data.pos_masks)
    pi_np = codonmod.codon_pi(spec.codonf, fcodon, f3x4, f1x4, graph)
    pf3x4 = codonmod.mg_pf3x4(spec.codonf, f3x4, f1x4)
    pi = jnp.asarray(pi_np, dtype)
    tips = jnp.asarray(data.tip_partials, dtype)
    fpatt = jnp.asarray(data.fpatt, dtype)
    branch_nodes = topo.branch_nodes()
    nb = len(branch_nodes)
    bn = jnp.asarray(branch_nodes)
    nnode = topo.nnode
    nkappa = 0 if spec.fix_kappa else (5 if spec.hkyREV else 1)
    B = _n_btypes(topo, spec.model) if spec.model else 1
    btype = np.zeros(nnode, dtype=np.int64)
    if spec.model == 2:
        btype = topo.labels.astype(np.int64)
    btype_j = jnp.asarray(btype)

    aa_i = jnp.asarray(graph.aa[graph.pi_idx])
    aa_j = jnp.asarray(graph.aa[graph.pj_idx])
    nonsyn = jnp.asarray(~graph.is_syn)
    ad = spec.aaDist
    if ad in (11, 12):                      # FIT1 / FIT2
        if B > 1:
            raise NotImplementedError(
                "FIT1/FIT2 with branch types is not supported (the "
                "fitness models tilt the equilibrium frequencies, which "
                "cannot differ per branch under one reversible chain)")
        n_pom = (4 + (ad == 12)) * B
        chem_p = jnp.asarray(AACHEM_P)
        chem_v = jnp.asarray(AACHEM_V)
        # fitness models tilt the equilibrium frequencies too
        # (reference: getpcodonClass, src/codeml.c:2049-2086:
        #  pi_fit(i) = pi0(i)/paa0(aa_i) * paaClass(aa_i),
        #  paaClass ∝ exp(2*fit))
        aa_of = jnp.asarray(graph.aa)
        paa0_np = np.zeros(20)
        np.add.at(paa0_np, graph.aa, pi_np)
        paa0 = jnp.asarray(np.maximum(paa0_np, 1e-300))
    elif ad == 7:                           # AAClasses
        text = spec.omegaAA or ""
        if text and "\n" not in text and len(text) < 4096:
            import os as _os
            if _os.path.exists(text):
                text = open(text).read()
        n_omega, cls = parse_omega_aa(text, graph)
        edge_cls = jnp.asarray(cls[np.asarray(graph.aa[graph.pi_idx]),
                                   np.asarray(graph.aa[graph.pj_idx])])
        n_pom = n_omega * B
    else:                                   # +-1..6 chemical distances
        D = aamod.load_distance(AADIST_FILES[abs(ad)])
        D = D / D.max()                     # reference: GetDaa normalization
        edge_d = jnp.asarray(D[np.asarray(graph.aa[graph.pi_idx]),
                               np.asarray(graph.aa[graph.pj_idx])])
        n_pom = 2 * B

    def unpack(x):
        t = x[:nb]
        k = nb
        kappa = x[k:k + nkappa] if nkappa else jnp.asarray(
            [spec.kappa] * (5 if spec.hkyREV else 1), dtype)
        k += nkappa
        pom = x[k:k + n_pom].reshape(B, -1)
        return t, kappa, pom

    def w_pair_of(pom_b):
        if ad in (11, 12):
            fit = (-pom_b[0] * (chem_p - pom_b[1]) ** 2
                   - pom_b[2] * (chem_v - pom_b[3]) ** 2)
            w = jnp.exp(-fit[aa_i] - fit[aa_j])
            if ad == 12:
                w = w * pom_b[4]
        elif ad == 7:
            w = pom_b[edge_cls]
        else:
            w = pom_b[0] * edge_d
            w = jnp.exp(-w) if ad > 0 else jnp.maximum(1.0 - w, 1e-8)
            w = w * pom_b[1]
        return jnp.where(nonsyn, w, 1.0)

    def neg_lnl(x):
        x = x.astype(dtype)
        t, kappa, pom = unpack(x)
        s = codonmod.mutation_part(graph, kappa if spec.hkyREV else kappa[0],
                                   pf3x4, spec.hkyREV, dtype)
        if ad in (11, 12):
            # fitness-tilted equilibrium frequencies (getpcodonClass)
            fit_aa = (-pom[0][0] * (chem_p - pom[0][1]) ** 2
                      - pom[0][2] * (chem_v - pom[0][3]) ** 2)
            paaC = jnp.exp(2.0 * fit_aa)
            paaC = paaC / jnp.sum(paaC)
            pi_use = pi / paa0[aa_of] * paaC[aa_of]
        else:
            pi_use = pi
        Qs, scales = [], []
        for b in range(B):
            w_pair = w_pair_of(pom[b])
            Qs.append(codonmod.build_Q_pair(graph, s, w_pair, pi_use))
            scales.append(1.0 / codonmod.mean_rate_pair(graph, s, w_pair,
                                                        pi_use))
        Qs = jnp.stack(Qs)
        scales = jnp.stack(scales)
        tfull = jnp.zeros((nnode,), dtype).at[bn].set(t)
        ts = tfull[:, None] * scales[None, :]               # [nnode, B]
        P_all = pmat_rev_multi(
            Qs, pi_use, ts)                                 # [nnode, B, n, n]
        P = _select_branch_type(P_all[:, :, None], btype, B)  # [nnode,1,n,n]
        piC = pi_use[None, :]
        return -pruning.lnL(P, tips, topo, piC, jnp.ones((1,), dtype), fpatt)

    t0 = np.clip(topo.blen0[branch_nodes], 0.0, BLEN_MAX)
    if not (t0 > 0).any():
        t0 = np.full(nb, 0.1)
    x0 = list(np.maximum(t0, BLEN_MIN * 2))
    bounds = [(BLEN_MIN, BLEN_MAX)] * nb
    if nkappa:
        x0 += [spec.kappa] * nkappa
        bounds += [(KAPPA_MIN, KAPPA_MAX)] * nkappa
    if ad in (11, 12):
        per = [0.5, 0.5, 0.5, 0.5] + ([spec.omega] if ad == 12 else [])
    elif ad == 7:
        per = [spec.omega] * (n_pom // B)
    else:
        per = [0.5, spec.omega]
    x0 += per * B
    bounds += [(OMEGA_MIN, OMEGA_MAX)] * n_pom
    return neg_lnl, unpack, np.array(x0), bounds, pi_np


def make_aa_objective(data: seqio.PackedData, topo: Topology,
                      spec: CodemlSpec, dtype=jnp.float64):
    """Amino-acid likelihood (reference: eigenQaa, src/codeml.c:3400;
    lfun/lfundG over 20 states).  Optional discrete-gamma rates via ncatG
    (aaml's fix_alpha/alpha).

    Parametric exchangeabilities: FromCodon (codon-chain aggregation with
    estimated kappa, fixed omega; eigenQaa FromCodon arm + Qcodon2aa,
    src/codeml.c:3419,3487), REVaa (189 free rates) and REVaa_0 (1-step
    pairs only), src/codeml.c:3424-3436."""
    from ..core.dgamma import discrete_gamma
    from ..models import aa as aamod

    model = spec.aa_model
    parametric = model in ("FromCodon", "REVaa", "REVaa_0")
    if parametric:
        pi_np = np.asarray(data.base_freqs, float)
        pi_np = pi_np / pi_np.sum()
        graph = codonmod.codon_graph(spec.icode)
        if model == "FromCodon":
            nrate = 0 if spec.fix_kappa else 1

            def S_of(rates):
                kap = rates[0] if nrate else jnp.asarray(spec.kappa, dtype)
                return aamod.from_codon_S(kap, spec.omega, pi_np, graph,
                                          dtype)
            Sjones = None
        else:
            g = graph if model == "REVaa_0" else None
            nrate = aamod.n_revaa_rates(model, graph)

            def S_of(rates):
                return aamod.revaa_S(rates, g, dtype)
            Sjones, _ = aamod.load_empirical(spec.aa_rate_file or "jones")
    else:
        S_static, pi_np = aamod.model_S_pi(model, spec.aa_rate_file,
                                           data.base_freqs)
        nrate = 0
        Q_static = jnp.asarray(np.asarray(
            aamod.build_aa_Q(S_static, pi_np)), dtype)
    pi = jnp.asarray(pi_np, dtype)
    tips = jnp.asarray(data.tip_partials, dtype)
    fpatt = jnp.asarray(data.fpatt, dtype)
    branch_nodes = topo.branch_nodes()
    nb = len(branch_nodes)
    bn = jnp.asarray(branch_nodes)
    nnode = topo.nnode
    use_gamma = (not spec.fix_alpha) or spec.alpha > 0
    K = spec.ncatG if use_gamma else 1
    est_alpha = use_gamma and not spec.fix_alpha

    def unpack(x):
        t = x[:nb]
        rates = x[nb:nb + nrate]
        k = nb + nrate
        alpha = x[k] if est_alpha else jnp.asarray(max(spec.alpha, 0.5),
                                                   dtype)
        return t, rates, alpha

    def neg_lnl(x):
        x = x.astype(dtype)
        t, rates, alpha = unpack(x)
        if parametric:
            Q = aamod.build_aa_Q(S_of(rates), pi)
        else:
            Q = Q_static
        if K > 1:
            r, w = discrete_gamma(alpha, K)
        else:
            r = jnp.ones((1,), dtype)
            w = jnp.ones((1,), dtype)
        tfull = jnp.zeros((nnode,), dtype).at[bn].set(t)
        ts = tfull[:, None] * r[None, :]
        P = pmat_rev(Q, pi, ts)
        piC = jnp.broadcast_to(pi, (K, 20))
        return -pruning.lnL(P, tips, topo, piC, w, fpatt)

    t0 = np.clip(topo.blen0[branch_nodes], 0.0, BLEN_MAX)
    if not (t0 > 0).any():
        t0 = np.full(nb, 0.1)
    t0 = np.maximum(t0, BLEN_MIN * 2)
    x0 = list(t0)
    bounds = [(BLEN_MIN, BLEN_MAX)] * nb
    if parametric and model == "FromCodon" and nrate:
        x0.append(spec.kappa)
        bounds.append((KAPPA_MIN, KAPPA_MAX))
    elif parametric and nrate:
        # initials from the empirical matrix, scaled so the reference pair
        # (19, 9) is 1 (reference GetInitials, src/codeml.c:2384-2392)
        from ..models.aa import IJ_AA_REF, aa_1step, aa_pairs_lower
        ii, jj = aa_pairs_lower()
        ref = Sjones[IJ_AA_REF[0], IJ_AA_REF[1]]
        vals = Sjones[ii, jj] / max(ref, 1e-8)
        isref = (ii == IJ_AA_REF[0]) & (jj == IJ_AA_REF[1])
        if model == "REVaa_0":
            fill = (aa_1step(graph) > 0) & ~isref
        else:
            fill = ~isref
        x0 += list(np.clip(vals[fill], 1e-4, 999.0))
        bounds += [(OMEGA_MIN, OMEGA_MAX)] * nrate
    if est_alpha:
        x0.append(spec.alpha if spec.alpha > 0 else 0.5)
        bounds.append((0.005, 99.0))
    return neg_lnl, unpack, np.array(x0), bounds, pi_np


def make_fromcodon0_objective(data: seqio.PackedData, topo: Topology,
                              spec: CodemlSpec, dtype=jnp.float64):
    """FromCodon0 (model 5): the AA data are treated as ambiguous codon
    data — each amino acid's tip partial is the indicator over its
    synonymous codons — and the likelihood runs on the 61-state codon
    chain with kappa and omega free and pi = equal-within-family codon
    frequencies (reference: src/codeml.c:498-556, com.pi <- fb61 and the
    z[]+64 AA-as-codon-set recoding)."""
    from ..models import aa as aamod

    graph = codonmod.codon_graph(spec.icode)
    faa = np.asarray(data.base_freqs, float)
    faa = faa / faa.sum()
    fb61 = aamod.aa2codonf(faa, graph)
    M = np.zeros((20, graph.n))
    M[graph.aa, np.arange(graph.n)] = 1.0
    tips_c = jnp.asarray(np.asarray(data.tip_partials) @ M, dtype)
    pi = jnp.asarray(fb61 / fb61.sum(), dtype)
    fpatt = jnp.asarray(data.fpatt, dtype)
    branch_nodes = topo.branch_nodes()
    nb = len(branch_nodes)
    bn = jnp.asarray(branch_nodes)
    nnode = topo.nnode
    nkappa = 0 if spec.fix_kappa else 1
    nomega = 0 if spec.fix_omega else 1

    def unpack(x):
        t = x[:nb]
        kap = x[nb] if nkappa else jnp.asarray(spec.kappa, dtype)
        om = x[nb + nkappa] if nomega else jnp.asarray(spec.omega, dtype)
        return t, kap, om

    def neg_lnl(x):
        x = x.astype(dtype)
        t, kap, om = unpack(x)
        s = codonmod.mutation_part(graph, kap, None, False, dtype)
        Q = codonmod.build_Q(graph, s, om, pi)
        mr = codonmod.mean_rate(graph, s, om, pi)
        tfull = jnp.zeros((nnode,), dtype).at[bn].set(t)
        P = pmat_rev(Q, pi, tfull[:, None] / mr)
        piC = jnp.broadcast_to(pi, (1, graph.n))
        return -pruning.lnL(P, tips_c, topo, piC, jnp.ones((1,), dtype),
                            fpatt)

    t0 = np.clip(topo.blen0[branch_nodes], 0.0, BLEN_MAX)
    if not (t0 > 0).any():
        t0 = np.full(nb, 0.3)
    t0 = np.maximum(t0, BLEN_MIN * 2)
    x0 = list(t0) + [spec.kappa] * nkappa + [spec.omega] * nomega
    bounds = ([(BLEN_MIN, BLEN_MAX)] * nb
              + [(KAPPA_MIN, KAPPA_MAX)] * nkappa
              + [(OMEGA_MIN, OMEGA_MAX)] * nomega)
    return neg_lnl, unpack, np.array(x0), bounds, np.asarray(pi)


def fit_aa_packed(data: seqio.PackedData, topo: Topology, spec: CodemlSpec,
                  dtype=None) -> CodemlResult:
    exp_dtype = dtype
    dtype = jnp.float64 if dtype is None else dtype
    if spec.aa_model == "FromCodon0":
        neg_lnl, unpack, x0, bounds, pi_np = \
            make_fromcodon0_objective(data, topo, spec, dtype)
        res = maximize_auto(
            lambda dt: make_fromcodon0_objective(data, topo, spec, dt)[0],
            neg_lnl, x0, bounds, explicit_dtype=exp_dtype)
        t, kap, om = unpack(jnp.asarray(res.x))
        return CodemlResult(
            lnL=res.lnL, np=len(res.x), blens=np.asarray(t),
            branch_nodes=topo.branch_nodes(),
            kappa=np.asarray([float(kap)]),
            params={"omega": float(om)}, pi=pi_np, topo=topo, fit=res,
            x=np.asarray(res.x), spec=spec)
    neg_lnl, unpack, x0, bounds, pi_np = \
        make_aa_objective(data, topo, spec, dtype)
    res = maximize_auto(
        lambda dt: make_aa_objective(data, topo, spec, dt)[0],
        neg_lnl, x0, bounds, explicit_dtype=exp_dtype)
    t, rates, alpha = unpack(jnp.asarray(res.x))
    kap = (np.asarray(rates) if spec.aa_model == "FromCodon"
           else np.zeros(0))
    return CodemlResult(
        lnL=res.lnL, np=len(res.x), blens=np.asarray(t),
        branch_nodes=topo.branch_nodes(), kappa=kap,
        params={"alpha": float(alpha), "rates": np.asarray(rates)},
        pi=pi_np, topo=topo, fit=res, x=np.asarray(res.x), spec=spec)


def _fit_aadist(data, topo, spec, dtype=None) -> CodemlResult:
    exp_dtype = dtype
    dtype = jnp.float64 if dtype is None else dtype
    neg_lnl, unpack, x0, bounds, pi_np = make_aadist_objective(
        data, topo, spec, dtype)
    # the (kappa, omega-class) surface is multimodal — e.g. mtCDNAape
    # aaDist=7 has a kappa->bound local optimum ~900 lnL below the global
    # one; spread starts over both axes mirror the reference's
    # rerun-with-new-initials advice
    nb_ = len(topo.branch_nodes())
    nkap = 0 if spec.fix_kappa else (5 if spec.hkyREV else 1)
    n_pom = len(x0) - nb_ - nkap
    multi = []
    kap_starts = ([None] if spec.fix_kappa or spec.hkyREV
                  else [None, 5.0, 20.0])
    for kap in kap_starts:
        for scale in (1.0, 0.1, 3.0):
            if kap is None and scale == 1.0:
                continue               # that's x0 itself
            st = x0.copy()
            if kap is not None:
                st[nb_] = kap
            st[-n_pom:] = np.asarray(x0[-n_pom:]) * scale
            multi.append(np.clip(st, [b[0] for b in bounds],
                                 [b[1] for b in bounds]))
    res = maximize_auto(
        lambda dt: make_aadist_objective(data, topo, spec, dt)[0],
        neg_lnl, x0, bounds, multi_start=multi, explicit_dtype=exp_dtype)
    t, kappa, pom = unpack(jnp.asarray(res.x))
    return CodemlResult(
        lnL=res.lnL, blens=np.asarray(t),
        branch_nodes=topo.branch_nodes(), kappa=np.asarray(kappa),
        params={"pomega": np.asarray(pom)}, pi=pi_np, np=len(res.x),
        topo=topo, fit=res, x=np.asarray(res.x))


def make_codon_mgene_objective(data: seqio.PackedData, topo: Topology,
                               spec: CodemlSpec, Mgene: int,
                               dtype=jnp.float64):
    """Multi-gene codon M0 likelihood (reference: SetPGene codeml.c:2421,
    MultipleGenes treesub.c:5170; ctl comment 'codon: 0:rates, 1:separate,
    2:diff pi, 3:diff kappa, 4:all diff').

    x layout mirrors the reference: t[nb], rgene[ngene-1], then one
    (kappa, omega) set (Mgene 0/2) or one per gene (Mgene 3/4).  pi is
    pooled for Mgene 0/3 and per-gene for Mgene 2/4; each gene's Q is
    normalized by its own mean rate and branch lengths scale by rgene_g
    (gene 0 is the reference with rate 1).
    """
    if Mgene not in (0, 2, 3, 4):
        raise ValueError(f"Mgene {Mgene} not handled here (1 = separate)")
    graph = codonmod.codon_graph(spec.icode)
    G = data.ngene
    posG = np.asarray(data.posG)
    per_pi = Mgene in (2, 4)
    per_rates = Mgene in (3, 4)

    pis, pfs, tips_g, fpatt_g = [], [], [], []
    for g in range(G):
        sl = slice(posG[g], posG[g + 1])
        if per_pi:
            pm = (data.pos_masks[:, sl] if data.pos_masks is not None
                  else None)
            fc, f3, f1 = codonmod.count_codon_freqs(
                data.tip_partials[:, sl], data.fpatt[sl], graph, pm)
        else:
            fc, f3, f1 = codonmod.count_codon_freqs(
                data.tip_partials, data.fpatt, graph, data.pos_masks)
        pis.append(jnp.asarray(
            codonmod.codon_pi(spec.codonf, fc, f3, f1, graph), dtype))
        pfs.append(codonmod.mg_pf3x4(spec.codonf, f3, f1))
        tp = data.tip_partials[:, sl]
        tips_g.append(jnp.asarray(tp) if tp.ndim == 2
                      else jnp.asarray(tp, dtype))
        fpatt_g.append(jnp.asarray(data.fpatt[sl], dtype))

    branch_nodes = topo.branch_nodes()
    nb = len(branch_nodes)
    bn = jnp.asarray(branch_nodes)
    nnode = topo.nnode
    nkappa1 = 0 if spec.fix_kappa else (5 if spec.hkyREV else 1)
    nomega1 = 0 if spec.fix_omega else 1
    nsets = G if per_rates else 1
    nrgene = G - 1

    def unpack(x):
        t = x[:nb]
        rgene = jnp.concatenate([jnp.ones((1,), dtype),
                                 x[nb:nb + nrgene]])
        k = nb + nrgene
        kaps, oms = [], []
        for gset in range(nsets):
            if nkappa1:
                kaps.append(x[k:k + nkappa1])
                k += nkappa1
            else:
                kaps.append(jnp.asarray(
                    [spec.kappa] * (5 if spec.hkyREV else 1), dtype))
            # reference: with Mgene>=3 && fix_omega only the LAST
            # partition's omega is fixed (codeml.c:2425 comment)
            fixed_here = spec.fix_omega and (not per_rates
                                             or gset == nsets - 1)
            if fixed_here:
                oms.append(jnp.asarray(spec.omega, dtype))
            else:
                oms.append(x[k])
                k += 1
        return t, rgene, kaps, oms

    def neg_lnl(x):
        x = x.astype(dtype)
        t, rgene, kaps, oms = unpack(x)
        tfull = jnp.zeros((nnode,), dtype).at[bn].set(t)
        total = jnp.asarray(0.0, dtype)
        for g in range(G):
            gset = g if per_rates else 0
            kap, om = kaps[gset], oms[gset]
            s = codonmod.mutation_part(
                graph, kap if spec.hkyREV else kap[0], pfs[g],
                spec.hkyREV, dtype)
            Q = codonmod.build_Q(graph, s, om, pis[g])
            mr = codonmod.mean_rate(graph, s, om, pis[g])
            P = pmat_rev(Q, pis[g], (tfull * rgene[g] / mr)[:, None])
            piC = jnp.broadcast_to(pis[g], (1, graph.n))
            total = total + pruning.lnL(P, tips_g[g], topo, piC,
                                        jnp.ones((1,), dtype), fpatt_g[g])
        return -total

    t0 = np.clip(topo.blen0[branch_nodes], 0.0, BLEN_MAX)
    if not (t0 > 0).any():
        t0 = np.full(nb, 0.1)
    t0 = np.maximum(t0, BLEN_MIN * 2)
    x0 = list(t0) + [1.0] * nrgene
    bounds = ([(BLEN_MIN, BLEN_MAX)] * nb + [(0.01, 99.0)] * nrgene)
    for gset in range(nsets):
        x0 += [spec.kappa] * nkappa1
        bounds += [(KAPPA_MIN, KAPPA_MAX)] * nkappa1
        fixed_here = spec.fix_omega and (not per_rates
                                         or gset == nsets - 1)
        if not fixed_here:
            x0 += [spec.omega]
            bounds += [(OMEGA_MIN, OMEGA_MAX)]
    return neg_lnl, unpack, np.array(x0), bounds, [np.asarray(p)
                                                   for p in pis]


def gene_slice(data: seqio.PackedData, g: int) -> seqio.PackedData:
    """Single-gene view of a multi-gene PackedData (reference:
    MultipleGenes' in-place pointer shuffle, src/treesub.c:5170)."""
    import dataclasses
    sl = data.gene_slice(g)
    lg = (int(data.lgene[g]) if data.lgene is not None
          else int(np.asarray(data.fpatt[sl]).sum()))
    return dataclasses.replace(
        data, tip_partials=data.tip_partials[:, sl],
        fpatt=data.fpatt[sl], ls=lg, ngene=1,
        posG=np.array([0, sl.stop - sl.start]),
        pos_masks=(data.pos_masks[:, sl] if data.pos_masks is not None
                   else None),
        site_pattern=None, pattern_site=None, lgene=None)


def fit_mgene_separate(data: seqio.PackedData, topo: Topology,
                       spec: CodemlSpec,
                       dtype=jnp.float64) -> list[CodemlResult]:
    """Mgene = 1: independent fit per gene (reference: MultipleGenes,
    src/treesub.c:5170)."""
    return [fit_packed(gene_slice(data, g), topo, spec, dtype)
            for g in range(data.ngene)]


def fit_codon_mgene(data: seqio.PackedData, topo: Topology,
                    spec: CodemlSpec, Mgene: int,
                    dtype=None) -> CodemlResult:
    exp_dtype = dtype
    dtype = jnp.float64 if dtype is None else dtype
    neg_lnl, unpack, x0, bounds, pis = make_codon_mgene_objective(
        data, topo, spec, Mgene, dtype)
    res = maximize_auto(
        lambda dt: make_codon_mgene_objective(data, topo, spec, Mgene,
                                              dt)[0],
        neg_lnl, x0, bounds, explicit_dtype=exp_dtype)
    t, rgene, kaps, oms = unpack(jnp.asarray(res.x))
    return CodemlResult(
        lnL=res.lnL, np=len(res.x), blens=np.asarray(t),
        branch_nodes=topo.branch_nodes(),
        kappa=np.asarray([float(k[0]) for k in kaps]),
        params={"rgene": np.asarray(rgene),
                "omegas": np.asarray([float(o) for o in oms])},
        pi=pis[0], topo=topo, fit=res, x=np.asarray(res.x), spec=spec)


def standard_errors(neg_lnl, x) -> np.ndarray:
    """SEs of the MLEs from the observed information matrix (autodiff
    Hessian of -lnL; replaces the reference's finite-difference Hessian /
    HessianSKT2004, src/treesub.c:7241).  Parameters pinned at bounds give
    near-singular information; pinv keeps the rest usable."""
    H = np.asarray(jax.hessian(neg_lnl)(jnp.asarray(x, jnp.float64)))
    cov = np.linalg.pinv((H + H.T) / 2)
    return np.sqrt(np.clip(np.diag(cov), 0.0, None))


def fit(seqfile: str, treefile: str, spec: CodemlSpec | None = None,
        tree_index: int = 0, dtype=jnp.float64) -> CodemlResult:
    spec = spec or CodemlSpec()
    seqtype = seqio.AA_SEQ if spec.seqtype == 2 else (
        seqio.CODON2AA_SEQ if spec.seqtype == 3 else seqio.CODON_SEQ)
    aln = seqio.read_alignment(seqfile, seqtype)
    data = seqio.pack(aln, cleandata=spec.cleandata, icode=spec.icode)
    trees = treeio.read_trees(treefile, data.names)
    topo = from_treenode(trees[tree_index], data.names)
    if spec.seqtype in (2, 3):
        return fit_aa_packed(data, topo, spec, dtype=dtype)
    return fit_packed(data, topo, spec, dtype=dtype)


def fit_packed(data: seqio.PackedData, topo: Topology, spec: CodemlSpec,
               dtype=None) -> CodemlResult:
    """Fit a codon model.  dtype=None selects the device policy: f64 on
    a CPU-default session, staged f32 fit + f64 polish on a GPU
    (optim.maximize_policy).  When a pattern mesh is engaged
    (parallel.sharding.engage_auto_mesh), the pattern axis is padded and
    the likelihood shard_maps across devices."""
    from ..parallel.sharding import maybe_pad_packed
    data = maybe_pad_packed(data)
    if spec.seqtype in (2, 3):
        return fit_aa_packed(data, topo, spec, dtype)
    if spec.aaDist:
        return _fit_aadist(data, topo, spec, dtype)
    if data.ngene > 1 and spec.Mgene != 1:
        if spec.model or spec.NSsites:
            raise ValueError("Mgene>0 with branch/NSsites models is not "
                             "supported (the reference zerrors too)")
        return fit_codon_mgene(data, topo, spec, spec.Mgene, dtype)
    exp_dtype = dtype
    dtype = jnp.float64 if dtype is None else dtype
    neg_lnl, unpack, classes_for, x0, bounds, pi_np = \
        make_codon_objective(data, topo, spec, dtype)
    multi = None
    if spec.codonf in ("FMutSel", "FMutSel0") and spec.estFreq:
        # staged fit: the 60-fitness (resp. 19-fitness) surface is ridged;
        # start the full model from the estFreq=0 optimum (branch lengths,
        # kappa, pi_TCA, omega) with data-derived fitness initials — the
        # same information the reference's GetInitialsCodon uses
        # (src/codeml.c:2111-2122)
        from dataclasses import replace as _dc_replace
        res0 = fit_packed(data, topo, _dc_replace(spec, estFreq=False),
                          exp_dtype)
        nb0 = len(topo.branch_nodes())
        nk0 = 0 if spec.fix_kappa else (5 if spec.hkyREV else 1)
        i2 = nb0 + nk0 + 3
        nfit0 = len(x0) - len(res0.x)
        # fitness initials chosen so pi(x_staged) == the stage-0
        # equilibrium frequencies exactly — the staged start then has the
        # stage-0 optimum's likelihood and the optimizer only improves
        graph0 = codonmod.codon_graph(spec.icode)
        pf0 = np.append(res0.x[i2 - 3:i2], 1.0)
        pf0 /= pf0.sum()
        mut3 = (pf0[graph0.pos_nt[:, 0]] * pf0[graph0.pos_nt[:, 1]]
                * pf0[graph0.pos_nt[:, 2]])
        pi0 = np.asarray(res0.pi, float)
        if spec.codonf == "FMutSel":
            f = np.log(np.maximum(pi0, 1e-300) / mut3)
            fit_init = f[:-1] - f[-1]
        else:
            mutbias = np.zeros(20)
            np.add.at(mutbias, graph0.aa, mut3)
            piAA0 = np.zeros(20)
            np.add.at(piAA0, graph0.aa, pi0)
            f = np.log(np.maximum(piAA0, 1e-300) / mutbias)
            fit_init = f[:19] - f[19]
        fit_init = np.clip(fit_init, -28.0, 28.0)
        staged = np.concatenate([res0.x[:i2], fit_init, res0.x[i2:]])
        multi = [np.concatenate([res0.x[:i2], x0[i2:i2 + nfit0],
                                 res0.x[i2:]]),
                 x0.copy()]
        x0 = staged
    if spec.NSsites and spec.model == 0:
        extras = nssites_extra_starts(spec.NSsites, spec.ncatG, spec.fix_omega)
        n_theta = nssites_nparams(spec.NSsites, spec.ncatG, spec.fix_omega)
        multi = []
        for th in extras:
            if len(th) != n_theta:
                continue
            s = x0.copy()
            s[-n_theta:] = th
            multi.append(s)
    elif spec.NSsites == M2A and spec.model == 3:
        # clade model C: vary w0 and the per-clade omegas
        nb_ = len(topo.branch_nodes())
        nth = len(x0) - nb_ - (0 if spec.fix_kappa else (5 if spec.hkyREV else 1))
        multi = []
        for th in ([2.0, 1.0, 0.01] + [3.0, 0.1][:nth - 3],
                   [0.0, 0.0, 0.3] + [0.5, 1.5][:nth - 3],
                   [1.0, -0.5, 0.05] + [1.0, 0.05][:nth - 3]):
            if len(th) != nth:
                continue
            s = x0.copy()
            s[-nth:] = th
            multi.append(s)
    elif spec.clock == 2:
        # local-clock rate classes sit on a (duration x rate) ridge; spread
        # rate starts so the optimizer can reach a boundary optimum
        # (reference rateb upper bound 999, SetxBound)
        from ..core.clockparam import make_clock_times
        _, n_time_ck, _, _, cinfo = make_clock_times(topo, 2)
        ncls = cinfo["n_rate_cls"]
        if ncls:
            multi = []
            for rv in (30.0, 300.0, 999.0):
                s = x0.copy()
                s[n_time_ck - ncls:n_time_ck] = rv
                multi.append(s)
    elif spec.NSsites == M2A and spec.model == 2:
        # branch-site A: vary the class proportions and foreground omega
        base_th = ([1.0, 0.5, 0.2] + ([] if spec.fix_omega else [2.0]))
        nth = len(base_th)
        multi = []
        for th in ([2.0, 1.0, 0.05] + ([] if spec.fix_omega else [5.0]),
                   [0.0, 0.0, 0.5] + ([] if spec.fix_omega else [1.2]),
                   [1.5, -0.5, 0.01] + ([] if spec.fix_omega else [10.0])):
            s = x0.copy()
            s[-nth:] = th
            multi.append(s)
    res = maximize_auto(
        lambda dt: make_codon_objective(data, topo, spec, dt)[0],
        neg_lnl, x0, bounds, multi_start=multi, explicit_dtype=exp_dtype)
    xj = jnp.asarray(res.x)
    t, kappa, ppi, theta = unpack(xj)
    W, freqs, _ = classes_for(theta)
    params = {"theta": np.asarray(theta), "W": np.asarray(W),
              "freqs": np.asarray(freqs)}
    if spec.codonf in ("FMutSel", "FMutSel0"):
        graph = codonmod.codon_graph(spec.icode)
        ppi_np = np.asarray(ppi)
        pf = np.append(ppi_np[:3], 1.0)
        pf /= pf.sum()
        params["pf_TCAG"] = pf
        params["fitness"] = ppi_np[3:]
        fit_j = jnp.asarray(ppi_np[3:]) if len(ppi_np) > 3 else None
        pi_np = np.asarray(codonmod.fmutsel_pi(
            spec.codonf, jnp.asarray(pf), fit_j, jnp.asarray(pi_np), graph,
            dtype))
    return CodemlResult(
        lnL=res.lnL, np=len(res.x), blens=np.asarray(t),
        branch_nodes=topo.branch_nodes(), kappa=np.asarray(kappa),
        params=params, pi=pi_np, topo=topo, fit=res, x=np.asarray(res.x),
        spec=spec, class_omegas=np.asarray(W), class_freqs=np.asarray(freqs))
