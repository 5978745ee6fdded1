"""Auto-discrete-gamma rate HMM over sites (baseml's AdG / nparK models).

The only cross-site dependency in the whole likelihood engine (SURVEY.md
section 5.7).  Re-implements the reference's `AutodGamma` transition
matrix (bivariate-normal bin probabilities, src/tools.c:2641) and the
`lfunAdG` forward recursion (src/treesub.c:7447) — here as either a
sequential `lax.scan` or a log-scaled `associative_scan` over per-site
K x K transition-weighted emission matrices, which parallelizes the site
axis.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .dgamma import discrete_gamma

_GL32 = np.polynomial.legendre.leggauss(32)


def binormal_cdf(h, k, r):
    """P(X<=h, Y<=k) for standard bivariate normals with correlation r
    (Drezner & Wesolowsky 1990 single-integral form), differentiable in
    all arguments via fixed Gauss-Legendre quadrature."""
    from jax.scipy.stats import norm
    x, w = jnp.asarray(_GL32[0]), jnp.asarray(_GL32[1])
    # t = r * (u+1)/2, u in [-1, 1]
    t = r * (x + 1.0) / 2.0
    one_m_t2 = jnp.maximum(1.0 - t * t, 1e-12)
    integrand = jnp.exp(-(h * h + k * k - 2.0 * h * k * t)
                        / (2.0 * one_m_t2)) / jnp.sqrt(one_m_t2)
    integral = jnp.sum(w * integrand) * (r / 2.0)
    return norm.cdf(h) * norm.cdf(k) + integral / (2.0 * jnp.pi)


def autod_gamma(alpha, rho, K: int):
    """(rates [K], freqs [K], M [K,K]) for the auto-discrete-gamma model
    (reference: AutodGamma, src/tools.c:2641).  M[i,j] = P(class_t = j |
    class_{t-1} = i), K * binormal bin mass."""
    from jax.scipy.special import ndtri
    pts = ndtri(jnp.arange(1, K) / K)
    big = 20.0
    edges = jnp.concatenate([pts, jnp.asarray([big])])
    # cumulative CDF at upper bin edges
    Cij = jax.vmap(lambda a: jax.vmap(
        lambda b: binormal_cdf(a, b, rho))(edges))(edges)   # [K,K]
    Cpad = jnp.zeros((K + 1, K + 1)).at[1:, 1:].set(Cij)
    bin_mass = (Cpad[1:, 1:] - Cpad[:-1, 1:] - Cpad[1:, :-1]
                + Cpad[:-1, :-1])
    M = jnp.maximum(bin_mass * K, 0.0)
    M = M / jnp.maximum(M.sum(1, keepdims=True), 1e-300)
    r, w = discrete_gamma(alpha, K)
    return r, w, M


def hmm_lnL(lnf_sites: jnp.ndarray, M: jnp.ndarray, freqK: jnp.ndarray,
            use_associative: bool = False) -> jnp.ndarray:
    """Total log-likelihood of the rate HMM.

    lnf_sites: [K, L] per-class per-SITE log-likelihoods (pattern-expanded,
    original site order).  Forward recursion b_{l} = (M b_{l-1}) * f_l with
    b_1 = f_1 and lnL = log(freqK . b_L)  (reference lfunAdG semantics).
    """
    K, L = lnf_sites.shape
    mx = jnp.max(lnf_sites, axis=0)                        # [L]
    f = jnp.exp(lnf_sites - mx[None, :])                   # [K, L]
    base = jnp.sum(mx)

    if not use_associative:
        def step(b, fl):
            b2 = (M @ b) * fl
            s = jnp.sum(b2)
            return b2 / s, jnp.log(s)

        b0 = f[:, 0]
        bN, logs = jax.lax.scan(step, b0 / jnp.sum(b0), f[:, 1:].T)
        lnL = (base + jnp.log(jnp.sum(f[:, 0]))
               + jnp.sum(logs) + jnp.log(freqK @ bN))
        return lnL

    # associative form: site l contributes A_l = diag(f_l) @ M (l >= 2);
    # products compose left-to-right; normalize each partial product and
    # carry log scales so the scan is stable
    A = f.T[1:, :, None] * M[None, :, :]                   # [L-1, K, K]
    s0 = jnp.log(jnp.maximum(A.max((1, 2)), 1e-300))
    A = A / jnp.exp(s0)[:, None, None]

    def combine(x, y):
        Ax, sx = x
        Ay, sy = y
        Z = jnp.einsum("...ij,...jk->...ik", Ay, Ax)
        m = jnp.maximum(Z.max((-2, -1)), 1e-300)
        return Z / m[..., None, None], sx + sy + jnp.log(m)

    Atot, stot = jax.lax.associative_scan(combine, (A, s0))
    Afin, sfin = Atot[-1], stot[-1]
    b0 = f[:, 0]
    lnL = (base + sfin
           + jnp.log(jnp.maximum(freqK @ (Afin @ b0), 1e-300)))
    return lnL
