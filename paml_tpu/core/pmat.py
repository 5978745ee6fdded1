"""Transition-probability kernels P(t) = expm(Q t).

One *batched* spectral kernel computes P for all branches
and site classes in a single einsum after a single symmetric
eigendecomposition (replacing the reference's per-branch `PMatUVRoot`,
src/tools.c:516, driven by `eigenQREV`, src/tools.c:5023).  A custom JVP
implements the Daleckii-Krein (divided-difference) derivative of the matrix
exponential in the eigenbasis, which stays exact when eigenvalues are
degenerate (JC69/K80 have repeated eigenvalues, where autodiff through
``eigh`` would produce NaNs).

A fused closed-form TN93-family kernel covers JC69/K80/F81/F84/HKY85/T92/
TN93 (reference closed forms: src/tools.c:566-666) without any
decomposition; all of those models are TN93 special cases.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# generic reversible spectral kernel
# ---------------------------------------------------------------------------


PI_FLOOR = 1e-100   # states with pi below this are dropped (reference:
                    # eigenQREV reduced computation, src/tools.c:5023)


def _sym_parts(Q: jnp.ndarray, pi: jnp.ndarray):
    """(S, sqp, mask): symmetrized Q restricted to pi > PI_FLOOR states.

    Zero-frequency states get zero S rows/cols and sqp 1, which yields
    identity rows in P — exactly the reference's reduced-matrix semantics
    for unobserved codons under Fcodon-style frequencies."""
    mask = pi > PI_FLOOR
    pi_safe = jnp.where(mask, pi, 1.0)
    sqp = jnp.sqrt(pi_safe)
    mm = mask[..., :, None] & mask[..., None, :]
    S = jnp.where(mm, Q * sqp[..., :, None] / sqp[..., None, :], 0.0)
    S = 0.5 * (S + jnp.swapaxes(S, -1, -2))
    return S, sqp, mask


def symmetrize(Q: jnp.ndarray, pi: jnp.ndarray) -> jnp.ndarray:
    """S = D^{1/2} Q D^{-1/2}, symmetric for reversible Q."""
    return _sym_parts(Q, pi)[0]


def _phi(mu_k: jnp.ndarray, mu_l: jnp.ndarray) -> jnp.ndarray:
    """Divided difference (e^{mu_k} - e^{mu_l}) / (mu_k - mu_l) with the
    e^{mu} limit at coincident values.  Near-coincident arguments use the
    expm1 form (avoids cancellation); far-apart arguments use the direct
    difference (avoids 0 * inf when exp(mu_l) underflows while expm1(d)
    overflows, e.g. at very long branches)."""
    d = mu_k - mu_l
    near = jnp.abs(d) < 0.5
    d_near = jnp.where(near, jnp.where(jnp.abs(d) < 1e-300, 0.0, d), 1.0)
    # expm1(x)/x, series-safe at 0
    ratio = jnp.where(jnp.abs(d_near) < 1e-8,
                      1.0 + 0.5 * d_near,
                      jnp.expm1(d_near) / jnp.where(d_near == 0, 1.0, d_near))
    phi_near = jnp.exp(mu_l) * ratio
    d_far = jnp.where(near, 1.0, d)
    phi_far = (jnp.exp(mu_k) - jnp.exp(mu_l)) / d_far
    return jnp.where(near, phi_near, phi_far)


def _eigh_refined(S: jnp.ndarray):
    """Symmetric eigendecomposition.  Hook kept as the single place to add
    iterative refinement if a harder Q family ever needs it."""
    return jnp.linalg.eigh(S)


# ---------------------------------------------------------------------------
# f32 path: uniformization + masked squaring (no eigendecomposition)
#
# The f32 spectral reconstruction carries ~2e-6 ABSOLUTE noise (eigh +
# einsum roundoff).  On a short branch the true off-diagonal entries are
# O(Q_ij * t) — often below 1e-5 — so that noise is a huge RELATIVE error
# exactly where site likelihoods divide by it.  Uniformization avoids it:
#   P(t) = e^{-qt} sum_k (qt)^k/k! M^k,   M = I + Q/q >= 0,  q = max -Q_ii
# has only positive terms — no cancellation — so every entry is computed
# to ~n*K*eps RELATIVE accuracy, and it is nothing but K tiny matmuls
# (no iterative solver).  Branches with a = q*t > 1 evaluate the
# series at a/2^s (s = ceil(log2 a), masked per branch) and square s
# times; squaring a positive matrix doubles the relative error per step,
# which for the <= _UNIF_NSQ steps needed here stays ~1e-4 — and those
# long branches have large entries where that is harmless.  This
# replaces the reference's eigenQREV + PMatUVRoot pipeline
# (src/tools.c:5023, :516) on the f32 path; f64 keeps the spectral form
# below with its Daleckii-Krein tangent (exact at degenerate
# eigenvalues).  The reference's own small-t escape hatch (t < 1e-10
# identity snap, src/tools.c:516-540) is subsumed.
# ---------------------------------------------------------------------------

_UNIF_K = 24          # series terms: Poisson tail P(X>24 | a0=5) ~ 3e-10
_UNIF_AMAX = 5.0      # series radius; above this, scale down and square
_UNIF_NSQ = 6         # max squarings: exact up to q*t = 512, clamped above


def _mat_powers(M, K):
    """[M^0..M^K] stacked on axis -3 (K-step sequential chain)."""
    n = M.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=M.dtype), M.shape)
    pows = [eye, M]
    for _ in range(2, K + 1):
        pows.append(jnp.matmul(pows[-1], M))
    return jnp.stack(pows, axis=-3)


def _pmat_rev_unif(Q: jnp.ndarray, pi: jnp.ndarray, t: jnp.ndarray):
    """f32 P(t): uniformization series + per-branch masked squaring.

    Zero-pi states get zeroed Q rows/cols hence identity P rows
    (reference reduced-Q semantics, eigenQREV src/tools.c:5023).
    Plain autodiff (matmul chain) — no eigh, no custom tangent needed."""
    n = Q.shape[-1]
    mask = pi > PI_FLOOR
    mm = mask[..., :, None] & mask[..., None, :]
    Qm = jnp.where(mm, Q, 0.0)
    q = jnp.maximum(jnp.max(-jnp.diagonal(Qm, axis1=-2, axis2=-1), -1), 1e-30)
    M = jnp.eye(n, dtype=Q.dtype) + Qm / q
    a = q * t                                       # [...] batch
    # M^k once (K tiny matmuls), then one weighted sum over k per branch
    Mk = _mat_powers(M, _UNIF_K)  # [K+1, n, n]
    # per-branch squaring count s = ceil(log2(a / AMAX)) clamped [0, NSQ];
    # with AMAX = 5 real datasets essentially never need squaring, so the
    # whole squaring loop sits behind a lax.cond and costs nothing unless
    # a line-search trial wanders to an extreme branch length
    s_b = jnp.ceil(jnp.log2(jnp.maximum(a / _UNIF_AMAX, 1.0)))
    s_b = jnp.minimum(s_b, float(_UNIF_NSQ))
    # clamp note (ADVICE r3): for q*t > AMAX * 2^NSQ the effective a0
    # saturates at 2*AMAX where the K-term Poisson tail is ~1e-4 (vs
    # ~3e-10 at AMAX) and d(a0)/dt is zero — harmless because P(t) is
    # then at stationarity to that same accuracy, but not the headline
    # tolerance; bump _UNIF_NSQ/_UNIF_K if such branch lengths matter
    a0 = jnp.minimum(a / (2.0 ** s_b), 2.0 * _UNIF_AMAX)  # >AMAX iff clamped
    # Poisson weights by the recurrence w_k = w_{k-1} * a0 / k (the
    # log-space form has a 0 * log(0) NaN in its tangent at t = 0)
    ws = [jnp.exp(-a0)]
    for k in range(1, _UNIF_K + 1):
        ws.append(ws[-1] * a0 / k)
    w = jnp.stack(ws, axis=-1)                      # [..., K+1]
    P = jnp.einsum("...k,kij->...ij", w, Mk)

    def _square(P):
        for i in range(_UNIF_NSQ):
            P2 = jnp.matmul(P, P)
            P = jnp.where((s_b > i)[..., None, None], P2, P)
        return P

    return jax.lax.cond(jnp.any(s_b > 0), _square, lambda P: P, P)


@jax.custom_jvp
def _pmat_rev_spectral(Q: jnp.ndarray, pi: jnp.ndarray,
                       t: jnp.ndarray) -> jnp.ndarray:
    """Spectral P(t) = D^{-1/2} U exp(Lam t) U^T D^{1/2} (f64 path)."""
    S, sqp, _ = _sym_parts(Q, pi)
    lam, U = _eigh_refined(S)
    L = U / sqp[:, None]              # [n, k]
    R = U.T * sqp[None, :]            # [k, n]
    e = jnp.exp(t[..., None] * lam)   # [..., k]
    P = jnp.einsum("ik,...k,kj->...ij", L, e, R)
    return jnp.maximum(P, 0.0)


def pmat_rev(Q: jnp.ndarray, pi: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """P(t) for a reversible rate matrix.

    Q: [n, n] reversible w.r.t. pi; pi: [n]; t: [...] any batch shape.
    Returns [..., n, n].  f64 uses the spectral form with a
    Daleckii-Krein tangent; f32 uses uniformization with
    masked squaring (see the design note above).
    """
    if jnp.result_type(Q) == jnp.float32:
        return _pmat_rev_unif(Q, pi, t)
    return _pmat_rev_spectral(Q, pi, t)


def pmat_rev_multi(Qs: jnp.ndarray, pi: jnp.ndarray,
                   ts: jnp.ndarray) -> jnp.ndarray:
    """P(t) for G rate matrices at once: Qs [G, n, n], pi [n] or [G, n],
    ts [..., G] -> P [..., G, n, n].

    Equivalent to vmap(pmat_rev) over G but keeps the f32 path's
    rarely-taken squaring loop behind ONE top-level lax.cond — a vmapped
    cond lowers to select and would execute the squaring matmuls on
    every call.
    """
    if jnp.result_type(Qs) != jnp.float32:
        pi_ax = None if jnp.ndim(pi) == 1 else 0
        return jax.vmap(_pmat_rev_spectral, in_axes=(0, pi_ax, -1),
                        out_axes=-3)(Qs, pi, ts)
    n = Qs.shape[-1]
    G = Qs.shape[0]
    mask = pi > PI_FLOOR                            # [n] or [G, n]
    if mask.ndim == 1:
        mask = jnp.broadcast_to(mask, (G, n))
    mm = mask[:, :, None] & mask[:, None, :]
    Qm = jnp.where(mm, Qs, 0.0)
    q = jnp.maximum(jnp.max(-jnp.diagonal(Qm, axis1=-2, axis2=-1), -1),
                    1e-30)                          # [G]
    M = jnp.eye(n, dtype=Qs.dtype) + Qm / q[:, None, None]
    Mk = _mat_powers(M, _UNIF_K)  # [G, K+1, n, n]
    a = q * ts                                      # [..., G]
    s_b = jnp.ceil(jnp.log2(jnp.maximum(a / _UNIF_AMAX, 1.0)))
    s_b = jnp.minimum(s_b, float(_UNIF_NSQ))
    a0 = jnp.minimum(a / (2.0 ** s_b), 2.0 * _UNIF_AMAX)
    ws = [jnp.exp(-a0)]
    for k in range(1, _UNIF_K + 1):
        ws.append(ws[-1] * a0 / k)
    w = jnp.stack(ws, axis=-1)                      # [..., G, K+1]
    P = jnp.einsum("...gk,gkij->...gij", w, Mk)

    def _square(P):
        for i in range(_UNIF_NSQ):
            P2 = jnp.matmul(P, P)
            P = jnp.where((s_b > i)[..., None, None], P2, P)
        return P

    return jax.lax.cond(jnp.any(s_b > 0), _square, lambda P: P, P)


@_pmat_rev_spectral.defjvp
def _pmat_rev_jvp(primals, tangents):
    Q, pi, t = primals
    dQ, dpi, dt = tangents
    S, sqp, mask = _sym_parts(Q, pi)
    lam, U = _eigh_refined(S)
    L = U / sqp[:, None]
    R = U.T * sqp[None, :]
    mu = t[..., None] * lam                       # [..., k]
    e = jnp.exp(mu)
    P = jnp.einsum("ik,...k,kj->...ij", L, e, R)

    # dS from dQ and dpi:  S = D^{1/2} Q D^{-1/2} on the pi > 0 states
    dQ = jnp.zeros_like(Q) if isinstance(dQ, jax.custom_derivatives.SymbolicZero) else dQ
    dpi = jnp.zeros_like(pi) if isinstance(dpi, jax.custom_derivatives.SymbolicZero) else dpi
    dt = jnp.zeros_like(t) if isinstance(dt, jax.custom_derivatives.SymbolicZero) else dt
    dpi = jnp.where(mask, dpi, 0.0)
    mm = mask[:, None] & mask[None, :]
    dsqp = dpi / (2.0 * sqp)
    dS = jnp.where(mm,
                   dQ * sqp[:, None] / sqp[None, :]
                   + Q * dsqp[:, None] / sqp[None, :]
                   - Q * sqp[:, None] * dsqp[None, :] / (sqp[None, :] ** 2),
                   0.0)
    dS = 0.5 * (dS + dS.T)

    # tangent of expm(S t) in the eigenbasis (Daleckii-Krein)
    G = jnp.einsum("ki,ij,jl->kl", U.T, dS, U)  # [k, l]
    # dM = t*dS + dt*S  ->  eigen-coords: t*G + dt*diag(lam)
    Phi = _phi(mu[..., :, None], mu[..., None, :])        # [..., k, l]
    dM_eig = t[..., None, None] * G + dt[..., None, None] * jnp.diag(lam)
    dE = dM_eig * Phi                              # [..., k, l]
    dP_core = jnp.einsum("ik,...kl,lj->...ij", L, dE, R)

    # contributions from d(D^{-1/2}) and d(D^{1/2}):
    # P = D^{-1/2} E' D^{1/2} with E' = U e U^T
    dinvsqp = -dsqp / pi                           # d(1/sqrt(pi))
    Ep = jnp.einsum("ik,...k,jk->...ij", U, e, U)
    dP_pi = (dinvsqp[:, None] * sqp[None, :] * Ep
             + (1.0 / sqp)[:, None] * dsqp[None, :] * Ep)
    # match the primal's max(P, 0) clip (otherwise the value under AD
    # differs from the plain value by the f32 eigh reconstruction noise)
    dP = jnp.where(P > 0, dP_core + dP_pi, 0.0)
    return jnp.maximum(P, 0.0), dP


# ---------------------------------------------------------------------------
# closed-form TN93 family (covers JC69, K80, F81, F84, HKY85, T92, TN93)
# ---------------------------------------------------------------------------

def tn93_rates(pi: jnp.ndarray, a1: jnp.ndarray, a2: jnp.ndarray, b: jnp.ndarray):
    """Normalize (alpha1, alpha2, beta) so the mean rate is 1."""
    pT, pC, pA, pG = pi[0], pi[1], pi[2], pi[3]
    pY, pR = pT + pC, pA + pG
    mr = 2.0 * (pT * pC * a1 + pA * pG * a2 + pY * pR * b)
    return a1 / mr, a2 / mr, b / mr


def pmat_tn93(pi: jnp.ndarray, a1, a2, b, t: jnp.ndarray,
              normalize: bool = True) -> jnp.ndarray:
    """Closed-form TN93 transition matrix, batched over t.

    States in T,C,A,G order.  alpha1: T<->C rate, alpha2: A<->G rate,
    beta: transversion rate (all before Q-normalization).
    Returns [..., 4, 4].
    """
    pT, pC, pA, pG = pi[0], pi[1], pi[2], pi[3]
    pY, pR = pT + pC, pA + pG
    if normalize:
        a1, a2, b = tn93_rates(pi, a1, a2, b)
    e2 = jnp.exp(-b * t)                                   # [...]
    e3 = jnp.exp(-(pY * a1 + pR * b) * t)
    e4 = jnp.exp(-(pR * a2 + pY * b) * t)

    one = jnp.ones_like(e2)

    TT = pT * one + pT * pR / pY * e2 + pC / pY * e3
    TC = pC * one + pC * pR / pY * e2 - pC / pY * e3
    TA = pA * (one - e2)
    TG = pG * (one - e2)
    CT = pT * one + pT * pR / pY * e2 - pT / pY * e3
    CC = pC * one + pC * pR / pY * e2 + pT / pY * e3
    CA, CG = TA, TG
    AA = pA * one + pA * pY / pR * e2 + pG / pR * e4
    AG = pG * one + pG * pY / pR * e2 - pG / pR * e4
    AT = pT * (one - e2)
    AC = pC * (one - e2)
    GA = pA * one + pA * pY / pR * e2 - pA / pR * e4
    GG = pG * one + pG * pY / pR * e2 + pA / pR * e4
    GT, GC = AT, AC

    P = jnp.stack([
        jnp.stack([TT, TC, TA, TG], axis=-1),
        jnp.stack([CT, CC, CA, CG], axis=-1),
        jnp.stack([AT, AC, AA, AG], axis=-1),
        jnp.stack([GT, GC, GA, GG], axis=-1),
    ], axis=-2)
    return P


def tn93_alphas(model: str, pi: jnp.ndarray, kappa):
    """Map a named model + reference kappa convention onto TN93
    (alpha1, alpha2, beta) with beta = 1 (pre-normalization).

    Conventions (reference: src/tools.c:566-666 and baseml SetParameters):
      JC69: kappa ignored, equal rates.     K80: kappa = alpha/beta.
      F81: all rates equal.                 HKY85: kappa = alpha/beta.
      F84: alpha1 = 1 + kappa/piY, alpha2 = 1 + kappa/piR.
      T92: HKY85 with pi = (1-gc, gc, 1-gc, gc)/2.
      TN93: kappa = (kappa1, kappa2).
    """
    pY = pi[0] + pi[1]
    pR = pi[2] + pi[3]
    one = jnp.asarray(1.0, dtype=pi.dtype)
    if model in ("JC69", "F81"):
        return one, one, one
    if model in ("K80", "HKY85", "T92"):
        k = kappa[0] if hasattr(kappa, "__len__") else kappa
        return k, k, one
    if model == "F84":
        k = kappa[0] if hasattr(kappa, "__len__") else kappa
        return 1.0 + k / pY, 1.0 + k / pR, one
    if model == "TN93":
        return kappa[0], kappa[1], one
    raise ValueError(f"not a TN93-family model: {model}")


# ---------------------------------------------------------------------------
# non-reversible: scaling-and-squaring expm (UNREST, UNRESTu)
# ---------------------------------------------------------------------------

def pmat_expm(Q: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """P(t) for a general (non-reversible) Q via expm; batched over t
    (reference: QUNREST + matexp, src/treesub.c:2543, src/tools.c:4879)."""
    def one(ti):
        return jax.scipy.linalg.expm(Q * ti)
    flat = t.reshape(-1)
    P = jax.vmap(one)(flat)
    return P.reshape(t.shape + Q.shape)
