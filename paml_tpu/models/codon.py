"""Codon substitution models (the codeml codon family).

Design: the codon graph (which sense-codon pairs differ at one
position, transition vs transversion, synonymous vs not) is precomputed
once per genetic code as static index arrays; Q construction is then a
vectorized scatter, and NSsites class matrices are formed as
Q_k = Qsyn + omega_k * Qnonsyn (the mean rate is linear in omega, so all
class normalizations come from two flux scalars).  This replaces the
reference's per-call i/j/ndiff triple loop in `eigenQcodon`
(src/codeml.c:3229-3310).

Frequency models (reference enum, src/codeml.c:215): Fequal F1x4 F3x4
Fcodon F1x4MG F3x4MG FMutSel0 FMutSel; data-derived frequencies follow
`InitializeCodon` (src/codeml.c:3772: pooled counts over species/genes);
Muse-Gaut multipliers follow `GetMutationMultiplier` (src/codeml.c:3060).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from ..constants import geneticcode_table, sense_codons

CODON_FREQ_MODELS = ["Fequal", "F1x4", "F3x4", "Fcodon",
                     "F1x4MG", "F3x4MG", "FMutSel0", "FMutSel"]


@dataclass(frozen=True)
class CodonGraph:
    icode: int
    n: int                     # number of sense codons
    sense: np.ndarray          # [n] codon index 0..63
    aa: np.ndarray             # [n] amino-acid index
    pos_nt: np.ndarray         # [n, 3] nucleotide (TCAG idx) at each position
    # single-difference pairs, i < j (indices into the sense list):
    pi_idx: np.ndarray         # [m]
    pj_idx: np.ndarray         # [m]
    pos: np.ndarray            # [m] changed codon position 0..2
    nt_i: np.ndarray           # [m] nucleotide in codon i at pos
    nt_j: np.ndarray           # [m]
    is_ts: np.ndarray          # [m] transition?
    gtr_class: np.ndarray      # [m] 0..5 = TC TA TG CA CG AG
    is_syn: np.ndarray         # [m]
    # unchanged positions (for Muse-Gaut multipliers): values and which row
    unch_pos: np.ndarray       # [m, 2] codon-position index of unchanged
    unch_nt: np.ndarray        # [m, 2] nucleotide at those positions


@lru_cache(maxsize=None)
def codon_graph(icode: int = 0) -> CodonGraph:
    sense = sense_codons(icode)
    tab = geneticcode_table(icode)
    n = len(sense)
    pos_nt = np.stack([sense // 16, (sense // 4) % 4, sense % 4], axis=1)
    aa = tab[sense]

    pi_l, pj_l, pos_l, nti_l, ntj_l = [], [], [], [], []
    for i in range(n):
        for j in range(i + 1, n):
            diff = np.nonzero(pos_nt[i] != pos_nt[j])[0]
            if len(diff) != 1:
                continue
            p = int(diff[0])
            pi_l.append(i)
            pj_l.append(j)
            pos_l.append(p)
            nti_l.append(int(pos_nt[i, p]))
            ntj_l.append(int(pos_nt[j, p]))
    pi_idx = np.array(pi_l, dtype=np.int32)
    pj_idx = np.array(pj_l, dtype=np.int32)
    pos = np.array(pos_l, dtype=np.int32)
    nt_i = np.array(nti_l, dtype=np.int32)
    nt_j = np.array(ntj_l, dtype=np.int32)
    # transitions: T<->C (0,1) or A<->G (2,3)
    s = nt_i + nt_j
    is_ts = (s == 1) | (s == 5)
    # GTR class by sorted changed pair: TC TA TG CA CG AG
    lo = np.minimum(nt_i, nt_j)
    hi = np.maximum(nt_i, nt_j)
    gtr_map = {(0, 1): 0, (0, 2): 1, (0, 3): 2, (1, 2): 3, (1, 3): 4, (2, 3): 5}
    gtr_class = np.array([gtr_map[(int(a), int(b))] for a, b in zip(lo, hi)],
                         dtype=np.int32)
    is_syn = aa[pi_idx] == aa[pj_idx]
    other = np.array([[1, 2], [2, 0], [0, 1]], dtype=np.int32)
    unch_pos = other[pos]                                   # [m, 2]
    unch_nt = pos_nt[pi_idx[:, None], unch_pos]             # [m, 2]
    return CodonGraph(icode=icode, n=n, sense=sense, aa=aa, pos_nt=pos_nt,
                      pi_idx=pi_idx, pj_idx=pj_idx, pos=pos,
                      nt_i=nt_i, nt_j=nt_j, is_ts=np.asarray(is_ts),
                      gtr_class=gtr_class, is_syn=np.asarray(is_syn),
                      unch_pos=unch_pos, unch_nt=unch_nt)


# ---------------------------------------------------------------------------
# codon frequencies from data (reference: InitializeCodon, src/codeml.c:3772)
# ---------------------------------------------------------------------------

def count_codon_freqs(tip_partials: np.ndarray, fpatt: np.ndarray,
                      graph: CodonGraph, pos_masks: np.ndarray | None = None):
    """Pooled codon counts over all species/sites -> (fcodon [n],
    f3x4 [3, 4], f1x4 [4]).

    With ambiguity characters present and `pos_masks` given ([ns, H, 3, 4]
    raw per-position nucleotide sets), ambiguous sites are resolved by the
    reference's 20-round iteration (InitializeCodon + AddCodonFreqSeqGene,
    src/codeml.c:3798-3768): each ambiguous codon's count is distributed
    over its compatible sense codons (resp. bases) in proportion to the
    current frequency estimates.

    tip_partials may also be integer state codes [ns, H] (clean data)."""
    tip_partials = np.asarray(tip_partials)
    if tip_partials.ndim == 2:
        ns = tip_partials.shape[0]
        fcodon = np.bincount(tip_partials.reshape(-1),
                             weights=np.tile(np.asarray(fpatt, float), ns),
                             minlength=graph.n)
        fcodon = fcodon / max(fcodon.sum(), 1e-300)
        f3 = np.zeros((3, 4))
        for p in range(3):
            for b in range(4):
                f3[p, b] = fcodon[graph.pos_nt[:, p] == b].sum()
        f1 = f3.mean(0)
        return (fcodon, f3 / f3.sum(1, keepdims=True), f1 / f1.sum())
    resolved = tip_partials.sum(-1) == 1
    w = tip_partials * (resolved[..., None] * fpatt[None, :, None])
    fcodon = w.sum((0, 1))
    fcodon = fcodon / max(fcodon.sum(), 1e-300)

    def marginals(fc):
        f3 = np.zeros((3, 4))
        for p in range(3):
            for b in range(4):
                f3[p, b] = fc[graph.pos_nt[:, p] == b].sum()
        f1 = f3.mean(0)
        return f3 / f3.sum(1, keepdims=True), f1 / f1.sum()

    f3x4, f1x4 = marginals(fcodon)

    has_ambig = not bool(resolved.all())
    if has_ambig and pos_masks is not None:
        # initial per-position counts from resolved positions of ALL sites
        fb3 = (pos_masks * (pos_masks.sum(-1, keepdims=True) == 1)
               * fpatt[None, :, None, None]).sum((0, 1)).astype(float)
        fb3 = fb3 / np.maximum(fb3.sum(1, keepdims=True), 1e-300)
        fb4 = fb3.mean(0)
        fb4 = fb4 / fb4.sum()
        fc0, f30, f40 = fcodon.copy(), fb3.copy(), fb4.copy()
        flat_sets = tip_partials > 0                       # [ns, H, n]
        for _ in range(20):
            # codon counts: distribute over compatible sense codons
            denom = flat_sets @ fc0                        # [ns, H]
            denom = np.maximum(denom, 1e-300)
            contrib = (flat_sets * fc0[None, None, :]
                       * (fpatt[None, :] / denom)[..., None])
            fc = contrib.sum((0, 1))
            fc = fc / max(fc.sum(), 1e-300)
            # per-position counts: distribute over compatible bases
            f3 = np.zeros((3, 4))
            f4 = np.zeros(4)
            for p in range(3):
                sel = pos_masks[:, :, p, :]                # [ns, H, 4]
                d3 = np.maximum(sel @ f30[p], 1e-300)
                f3[p] = (sel * f30[p][None, None, :]
                         * (fpatt[None, :] / d3)[..., None]).sum((0, 1))
                d4 = np.maximum(sel @ f40, 1e-300)
                f4 += (sel * f40[None, None, :]
                       * (fpatt[None, :] / d4)[..., None]).sum((0, 1))
            f3 = f3 / np.maximum(f3.sum(1, keepdims=True), 1e-300)
            f4 = f4 / max(f4.sum(), 1e-300)
            d = max(np.abs(fc - fc0).max(), np.abs(f3 - f30).max(),
                    np.abs(f4 - f40).max())
            fc0, f30, f40 = fc, f3, f4
            if d < 1e-8:
                break
        fcodon, f3x4, f1x4 = fc0, f30, f40
    return fcodon, f3x4, f1x4


def codon_pi(codonf: str, fcodon, f3x4, f1x4, graph: CodonGraph) -> np.ndarray:
    """Equilibrium codon frequencies under the frequency model."""
    n = graph.n
    if codonf == "Fequal":
        pi = np.full(n, 1.0 / n)
    elif codonf in ("Fcodon", "FMutSel0", "FMutSel"):
        pi = np.asarray(fcodon, dtype=np.float64).copy()
    elif codonf in ("F3x4", "F3x4MG"):
        pi = (f3x4[0][graph.pos_nt[:, 0]] * f3x4[1][graph.pos_nt[:, 1]]
              * f3x4[2][graph.pos_nt[:, 2]])
    elif codonf in ("F1x4", "F1x4MG"):
        pi = (f1x4[graph.pos_nt[:, 0]] * f1x4[graph.pos_nt[:, 1]]
              * f1x4[graph.pos_nt[:, 2]])
    else:
        raise ValueError(f"unknown codonf {codonf}")
    return pi / pi.sum()


def mg_pf3x4(codonf: str, f3x4, f1x4) -> np.ndarray | None:
    """Position-specific frequency table used by the Muse-Gaut multiplier.
    F1x4MG/FMutSel use the position-averaged table (reference writes the
    1x4 table into all three rows, src/codeml.c:3884-3893)."""
    if codonf in ("F3x4MG",):
        return np.asarray(f3x4)
    if codonf in ("F1x4MG", "FMutSel0", "FMutSel"):
        return np.tile(np.asarray(f1x4)[None, :], (3, 1))
    return None


# ---------------------------------------------------------------------------
# Q construction
# ---------------------------------------------------------------------------

def mutation_part(graph: CodonGraph, kappa, pf3x4=None, hkyrev: bool = False,
                  dtype=jnp.float64):
    """Symmetric mutation exchangeabilities s[m] for the 1-difference pairs.

    kappa: scalar HKY kappa, or [5] GTR rates (TC TA TG CA CG, AG=1).
    pf3x4: [3,4] table for Muse-Gaut multipliers (None for plain F models).
    """
    m = len(graph.pi_idx)
    if hkyrev:
        rates6 = jnp.concatenate([jnp.asarray(kappa, dtype).reshape(-1),
                                  jnp.ones((1,), dtype)])
        s = rates6[graph.gtr_class]
    else:
        k = jnp.asarray(kappa, dtype).reshape(())
        s = jnp.where(jnp.asarray(graph.is_ts), k, 1.0)
    if pf3x4 is not None:
        pf = jnp.asarray(pf3x4, dtype)
        f1 = pf[graph.unch_pos[:, 0], graph.unch_nt[:, 0]]
        f2 = pf[graph.unch_pos[:, 1], graph.unch_nt[:, 1]]
        s = s / (f1 * f2)
    return s


# ---------------------------------------------------------------------------
# FMutSel / FMutSel0 mutation-selection models (Yang & Nielsen 2008)
# reference: GetCodonFreqs src/codeml.c:2689, GetMutationMultiplier :3060
# ---------------------------------------------------------------------------

def observed_piAA(fcodon, graph: CodonGraph) -> np.ndarray:
    """Observed amino-acid frequencies pooled from codon frequencies."""
    piAA = np.zeros(20)
    np.add.at(piAA, graph.aa, np.asarray(fcodon))
    return piAA / piAA.sum()


def _mut3(pf, graph: CodonGraph):
    """Per-codon mutation-bias product pf[b0]*pf[b1]*pf[b2] ([n])."""
    return (pf[graph.pos_nt[:, 0]] * pf[graph.pos_nt[:, 1]]
            * pf[graph.pos_nt[:, 2]])


def fmutsel_pi(codonf: str, pf, fit, fcodon_obs, graph: CodonGraph,
               dtype=jnp.float64):
    """Equilibrium codon frequencies under FMutSel/FMutSel0.

    pf: [4] normalized mutation-bias nucleotide frequencies (traced).
    fit: estimated fitnesses — [n-1] codon fitnesses (FMutSel) or [19]
    amino-acid fitnesses (FMutSel0), last one fixed at 0 — or None for the
    estFreq=0 parameterization.  Reference: GetCodonFreqs,
    src/codeml.c:2689-2755.
    """
    mut3 = _mut3(pf, graph)
    if codonf == "FMutSel":
        if fit is None:
            # npi=3: codon frequencies stay at the observed values
            # (codeml.c:2715 early return keeps com.pi from the data)
            pi = jnp.asarray(fcodon_obs, dtype)
        else:
            pi = mut3 * jnp.exp(jnp.concatenate(
                [fit, jnp.zeros((1,), dtype)]))
    elif codonf == "FMutSel0":
        aa = jnp.asarray(graph.aa)
        if fit is None:
            # npi=3: within-family mutation bias x observed AA frequencies
            # (codeml.c:2737-2752)
            piAA = jnp.asarray(observed_piAA(fcodon_obs, graph), dtype)
            mutbias = jnp.zeros((20,), dtype).at[aa].add(mut3)
            pi = mut3 / mutbias[aa] * piAA[aa]
        else:
            fit20 = jnp.concatenate([fit, jnp.zeros((1,), dtype)])
            pi = mut3 * jnp.exp(fit20[aa])
    else:
        raise ValueError(codonf)
    return pi / jnp.sum(pi)


def fmutsel_multiplier(graph: CodonGraph, pf, pi, ls: int,
                       dtype=jnp.float64):
    """Fixation-probability multiplier for the single-step pairs ([m]).

    eFit_i = max(pi_i, small)/mut3_i; the pair factor is
    (ln eF_a - ln eF_b)/(eF_a - eF_b), i.e. S_ij/(1-e^-S_ij) folded with
    the mutation part, with the neutral-limit fallback 1/eF_a (reference:
    GetMutationMultiplier, src/codeml.c:3074-3084; the reference computes
    the pair once for (i>j) and assigns symmetrically, codeml.c:3305).
    The 1/(pf*pf) unchanged-position division is handled by
    `mutation_part` via the tiled pf3x4 table.
    """
    small = min(1e-6, 1.0 / max(int(ls), 1))
    mut3 = _mut3(pf, graph)
    eF = jnp.maximum(pi, small) / mut3
    ea = eF[graph.pi_idx]          # reference's "to" codon (lower index)
    eb = eF[graph.pj_idx]          # reference's "from" codon
    d = ea - eb
    safe_d = jnp.where(jnp.abs(d) > 1e-10, d, 1.0)
    ratio = (jnp.log(ea) - jnp.log(eb)) / safe_d
    return jnp.where(jnp.abs(d) > 1e-10, ratio, 1.0 / ea)


def selection_coefficients(graph: CodonGraph, pf, pi, kappa, omega,
                           hkyrev: bool, ls: int):
    """Per-pair 2Ns selection coefficients and mutation/substitution flux
    (reference: SelectionCoefficients, src/codeml.c:3089).

    Returns dict with pair arrays Ns [m], qmut [m] (i->j flux = pi_i q
    pf_toj), qsub, qsubw, and summary stats matching the reference output.
    """
    pf = np.asarray(pf, float)
    pi = np.asarray(pi, float)
    small = min(1e-6, 1.0 / max(int(ls), 1))
    mut3 = np.asarray(_mut3(pf, graph))
    eF = np.maximum(pi, small) / mut3
    a, b = graph.pi_idx, graph.pj_idx
    # reference iterates i>j: from=i (higher)=b... Ns[i,j] = log(eF_j/eF_i)
    Ns_ba = np.log(eF[a] / eF[b])      # 2Ns for b -> a
    if hkyrev:
        rates6 = np.concatenate([np.asarray(kappa, float).reshape(-1),
                                 [1.0]])
        q = rates6[graph.gtr_class]
    else:
        q = np.where(graph.is_ts, float(np.asarray(kappa).reshape(-1)[0]),
                     1.0)
    qmut_ba = pi[b] * q * pf[graph.nt_i]   # b(=j-sense from) -> a flux
    qmut_ab = pi[a] * q * pf[graph.nt_j]
    nz = np.abs(Ns_ba) > 1e-20
    fac_ba = np.where(nz, Ns_ba / (1 - np.exp(-Ns_ba)), 1.0)
    fac_ab = np.where(nz, -Ns_ba / (1 - np.exp(Ns_ba)), 1.0)
    qsub_ba = qmut_ba * fac_ba
    qsub_ab = qmut_ab * fac_ab
    wfac = np.where(graph.is_syn, 1.0, float(omega))
    return {
        "Ns_ba": Ns_ba, "qmut_ba": qmut_ba, "qmut_ab": qmut_ab,
        "qsub_ba": qsub_ba, "qsub_ab": qsub_ab,
        "qsubw_ba": qsub_ba * wfac, "qsubw_ab": qsub_ab * wfac,
        "is_syn": np.asarray(graph.is_syn),
    }


@lru_cache(maxsize=None)
def _dense_tables(icode: int):
    """Dense [n, n] constant tables for scatter-free Q construction.

    With these masks the per-evaluation Q build is pure
    elementwise/gather work (reference semantics identical to
    eigenQcodon's pair loop, src/codeml.c:3229-3301)."""
    g = codon_graph(icode)
    n = g.n

    def dense(vals, fill=0.0, dt=np.float64):
        D = np.full((n, n), fill, dt)
        D[g.pi_idx, g.pj_idx] = vals
        D[g.pj_idx, g.pi_idx] = vals
        return D

    ts = dense(g.is_ts.astype(np.float64))
    tv = dense((~g.is_ts).astype(np.float64))
    syn = dense(g.is_syn.astype(np.float64))
    nonsyn = dense((~g.is_syn).astype(np.float64))
    gtr = dense(g.gtr_class, fill=6, dt=np.int32)   # 6 = not a pair -> 0
    pairm = dense(np.ones(len(g.pi_idx)))
    # Muse-Gaut divisor index tables: the two unchanged positions of the
    # pair (both orientations share them); 0s off-pairs (divisor -> 1)
    up0 = dense(g.unch_pos[:, 0], dt=np.int32)
    up1 = dense(g.unch_pos[:, 1], dt=np.int32)
    un0 = dense(g.unch_nt[:, 0], dt=np.int32)
    un1 = dense(g.unch_nt[:, 1], dt=np.int32)
    return dict(ts=ts, tv=tv, syn=syn, nonsyn=nonsyn, gtr=gtr,
                pair=pairm, up0=up0, up1=up1, un0=un0, un1=un1)


def mutation_dense(graph: CodonGraph, kappa, pf3x4=None,
                   hkyrev: bool = False, dtype=jnp.float64):
    """Dense symmetric mutation exchangeabilities [n, n] (zero off the
    1-difference pairs); the scatter-free equivalent of mutation_part."""
    T = _dense_tables(graph.icode)
    if hkyrev:
        rates7 = jnp.concatenate([jnp.asarray(kappa, dtype).reshape(-1),
                                  jnp.ones((1,), dtype),
                                  jnp.zeros((1,), dtype)])
        s = rates7[jnp.asarray(T["gtr"])]
    else:
        k = jnp.asarray(kappa, dtype).reshape(())
        s = k * jnp.asarray(T["ts"], dtype) + jnp.asarray(T["tv"], dtype)
    if pf3x4 is not None:
        pf = jnp.asarray(pf3x4, dtype)
        f1 = pf[jnp.asarray(T["up0"]), jnp.asarray(T["un0"])]
        f2 = pf[jnp.asarray(T["up1"]), jnp.asarray(T["un1"])]
        # off-pair cells have s == 0 but would divide 0/0 -> NaN when a
        # position frequency is exactly zero; clamp the denominator
        s = s / jnp.maximum(f1 * f2, jnp.finfo(dtype).tiny)
    return s


def build_Q_dense(graph: CodonGraph, s_dense, omega, pi, dtype=None):
    """Unnormalized Q from a dense mutation matrix — no scatters."""
    T = _dense_tables(graph.icode)
    if dtype is None:
        dtype = jnp.result_type(s_dense.dtype, jnp.asarray(pi).dtype)
    wfac = (jnp.asarray(T["syn"], dtype)
            + omega * jnp.asarray(T["nonsyn"], dtype))
    Q = s_dense.astype(dtype) * wfac * jnp.asarray(pi, dtype)[None, :]
    return Q - jnp.diag(jnp.sum(Q, axis=1))


def flux_dense(graph: CodonGraph, s_dense, pi):
    """(rs, ra) from the dense mutation matrix (== flux on pairs)."""
    T = _dense_tables(graph.icode)
    dt = s_dense.dtype
    base = pi[:, None] * s_dense * pi[None, :]
    rs = jnp.sum(base * jnp.asarray(T["syn"], dt))
    ra = jnp.sum(base * jnp.asarray(T["nonsyn"], dt))
    return rs, ra


def flux(graph: CodonGraph, s, pi):
    """Synonymous and nonsynonymous flux at omega=1:
    mr(Q(omega)) = rs + omega * ra."""
    contrib = s * (pi[graph.pi_idx] * pi[graph.pj_idx]) * 2.0
    syn = jnp.asarray(graph.is_syn)
    rs = jnp.sum(jnp.where(syn, contrib, 0.0))
    ra = jnp.sum(jnp.where(syn, 0.0, contrib))
    return rs, ra


def build_Q(graph: CodonGraph, s, omega, pi, dtype=None):
    """Unnormalized Q (off-diagonals + diagonal).  omega scalar."""
    n = graph.n
    vals = s * jnp.where(jnp.asarray(graph.is_syn), 1.0, omega)
    if dtype is None:
        dtype = jnp.result_type(vals.dtype, jnp.asarray(pi).dtype)
    Q = jnp.zeros((n, n), dtype)
    Q = Q.at[graph.pi_idx, graph.pj_idx].set(vals * pi[graph.pj_idx])
    Q = Q.at[graph.pj_idx, graph.pi_idx].set(vals * pi[graph.pi_idx])
    Q = Q - jnp.diag(jnp.sum(Q, axis=1))
    return Q


def mean_rate(graph: CodonGraph, s, omega, pi):
    rs, ra = flux(graph, s, pi)
    return rs + omega * ra


def branch_dnds(graph: CodonGraph, s, pi, omega, t, ls: int):
    """Per-branch dN/dS statistics (reference: eigenQcodon mode=2,
    src/codeml.c:3357-3377): S/N expected site counts and dS/dN for a
    branch of length t (substitutions per codon) under omega."""
    rs, ra = (float(v) for v in flux(graph, s, pi))
    w = float(omega)
    mr = rs + w * ra
    tot0 = rs + ra
    rho_s, rho_a = rs / tot0, ra / tot0
    S = rho_s * 3 * ls
    N = rho_a * 3 * ls
    if t <= 0 or mr <= 0:
        return dict(t=float(t), S=S, N=N, w=w, dN=0.0, dS=0.0)
    dS = t * (rs / mr) / (3 * rho_s)
    dN = t * (w * ra / mr) / (3 * rho_a)
    return dict(t=float(t), S=S, N=N, w=(dN / dS if dS > 0 else -1.0),
                dN=dN, dS=dS)


def build_Q_pair(graph: CodonGraph, s, w_pair, pi, dtype=None):
    """Unnormalized Q with a per-single-step-pair omega factor
    (reference: GetOmega applied inside eigenQcodon, src/codeml.c:3298-3301
    for aaDist/AAClasses/FIT models).  w_pair [m] should be 1 on
    synonymous pairs."""
    n = graph.n
    vals = s * w_pair
    if dtype is None:
        dtype = jnp.result_type(vals.dtype, jnp.asarray(pi).dtype)
    Q = jnp.zeros((n, n), dtype)
    Q = Q.at[graph.pi_idx, graph.pj_idx].set(vals * pi[graph.pj_idx])
    Q = Q.at[graph.pj_idx, graph.pi_idx].set(vals * pi[graph.pi_idx])
    Q = Q - jnp.diag(jnp.sum(Q, axis=1))
    return Q


def mean_rate_pair(graph: CodonGraph, s, w_pair, pi):
    return jnp.sum(s * w_pair * pi[graph.pi_idx] * pi[graph.pj_idx] * 2.0)
