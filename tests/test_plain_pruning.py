"""The pruning paths (level, wide, scan, lnL_chunked) against the plain
float64 reference (paml_tpu/core/plain_pruning.py), value and gradient.

Every path is reached through the public entry points; the dispatch
thresholds are lowered so that small trees take the wide and scan paths.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import conftest  # noqa: F401
from paml_tpu.core import plain_pruning, pruning
from paml_tpu.core.topology import from_treenode
from paml_tpu.io import treeio


def _ladder(ns):
    nwk = "t0"
    for i in range(1, ns):
        nwk = f"({nwk},t{i})"
    return nwk + ";", ns


def _balanced(ns):
    def bal(lo, hi):
        if hi - lo == 1:
            return f"t{lo}"
        m = (lo + hi) // 2
        return f"({bal(lo, m)},{bal(m, hi)})"
    return bal(0, ns) + ";", ns


TREES = {
    "ladder": _ladder(9),
    "balanced": _balanced(8),
    # polytomies of degree 3 and 4 at the root and inside
    "multifurcating": ("((t0,t1,t2),(t3,t4),t5,(t6,(t7,t8,t9)));", 10),
}


def _problem(tree, tips_kind, H, C=3, n=7, seed=0):
    nwk, ns = TREES[tree]
    names = [f"t{i}" for i in range(ns)]
    topo = from_treenode(treeio.parse_newick(nwk), names)
    rng = np.random.default_rng(seed)
    P = rng.gamma(1.0, 1.0, size=(topo.nnode, C, n, n))
    P = 0.6 * np.eye(n) + 0.4 * P / P.sum(-1, keepdims=True)
    pi = rng.dirichlet(np.ones(n), size=C)
    w = rng.dirichlet(np.ones(C))
    fpatt = rng.integers(1, 6, size=H).astype(np.float64)
    states = rng.integers(0, n, size=(ns, H))
    if tips_kind == "states":
        tips = states.astype(np.int32)
    else:
        # one-hot partials with some ambiguous (multi-state) entries
        tips = np.eye(n)[states]
        amb = rng.random((ns, H)) < 0.1
        tips[amb] = np.maximum(tips[amb], rng.random((amb.sum(), n)) < 0.5)
    return topo, jnp.asarray(P), jnp.asarray(tips), jnp.asarray(pi), \
        jnp.asarray(w), jnp.asarray(fpatt)


def _force_path(monkeypatch, path):
    if path == "wide":
        monkeypatch.setattr(pruning, "_WIDE_NNODE", 0)
    elif path == "scan":
        monkeypatch.setattr(pruning, "_MAX_UNROLL", 0)


CASES = [
    # path, tree, tips, n_patterns (ragged: not a power of two)
    ("level", "ladder", "states", 37),
    ("level", "balanced", "onehot", 64),
    ("level", "multifurcating", "states", 13),
    ("level", "multifurcating", "onehot", 29),
    ("wide", "ladder", "onehot", 21),
    ("wide", "balanced", "states", 50),
    ("wide", "multifurcating", "states", 9),
    ("wide", "multifurcating", "onehot", 31),
    ("scan", "ladder", "states", 17),
    ("scan", "balanced", "onehot", 40),
    ("scan", "multifurcating", "onehot", 11),
    ("scan", "multifurcating", "states", 23),
    ("chunked", "balanced", "states", 48),
    ("chunked", "ladder", "onehot", 30),
    ("chunked", "multifurcating", "states", 27),
]


@pytest.mark.parametrize("path,tree,tips_kind,H", CASES)
def test_paths_match_plain_reference(monkeypatch, path, tree, tips_kind, H):
    topo, P, tips, pi, w, fpatt = _problem(tree, tips_kind, H)
    _force_path(monkeypatch, path)

    def ours(P_, pi_):
        if path == "chunked":
            return pruning.lnL_chunked(P_, tips, topo, pi_, w, fpatt, 3)
        return pruning.lnL(P_, tips, topo, pi_, w, fpatt)

    def ref(P_, pi_):
        return plain_pruning.lnL(P_, tips, topo, pi_, w, fpatt)

    v, (gP, gpi) = jax.jit(jax.value_and_grad(ours, argnums=(0, 1)))(P, pi)
    vr, (gPr, gpir) = jax.jit(jax.value_and_grad(ref, argnums=(0, 1)))(P, pi)
    assert abs(float(v) - float(vr)) <= 1e-12 * abs(float(vr))
    scale = float(jnp.max(jnp.abs(gPr)))
    assert float(jnp.max(jnp.abs(gP - gPr))) <= 1e-10 * scale
    assert float(jnp.max(jnp.abs(gpi - gpir))) <= 1e-10 * float(
        jnp.max(jnp.abs(gpir)))


@pytest.mark.parametrize("path", ["level", "wide", "scan"])
def test_dispatch_picks_path(monkeypatch, path):
    """class_site_lnf picks the path from the tree: depth above
    _MAX_UNROLL levels -> scan, more than _WIDE_NNODE nodes -> wide,
    otherwise level."""
    topo, P, tips, pi, w, fpatt = _problem("balanced", "states", 8)
    _force_path(monkeypatch, path)
    called = []
    for name in ("_class_site_lnf_lvl", "_class_site_lnf_wide",
                 "_class_site_lnf_scan"):
        real = getattr(pruning, name)
        monkeypatch.setattr(pruning, name,
                            lambda *a, _n=name, _r=real: called.append(_n)
                            or _r(*a))
    pruning.class_site_lnf(P, tips, topo, pi)
    assert called == [{"level": "_class_site_lnf_lvl",
                       "wide": "_class_site_lnf_wide",
                       "scan": "_class_site_lnf_scan"}[path]]


@pytest.mark.parametrize("tree", ["ladder", "multifurcating"])
def test_f32_level_path_within_parity_bar(tree):
    """The f32 level path stays within the repo's 1e-5 relative lnL bar
    (SURVEY.md section 7) of the float64 reference."""
    topo, P, tips, pi, w, fpatt = _problem(tree, "states", 64, seed=5)
    v32 = pruning.lnL(P.astype(jnp.float32), tips, topo,
                      pi.astype(jnp.float32), w.astype(jnp.float32),
                      fpatt.astype(jnp.float32))
    assert v32.dtype == jnp.float32
    vr = plain_pruning.lnL(P, tips, topo, pi, w, fpatt)
    assert abs(float(v32) - float(vr)) <= 1e-5 * abs(float(vr))
