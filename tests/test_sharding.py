"""Sharded execution == replicated execution, on the 8-device CPU mesh.

SURVEY.md section 4: multi-device tests must assert equality of the
psum'd lnL against the single-host value.  The pattern axis is pure data
parallelism, so up to reduction reassociation the sharded value must match
the replicated one to tight tolerance (exact arithmetic here: x64 on CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import conftest  # noqa: F401
from paml_tpu.apps import baseml as baseml_app
from paml_tpu.apps import codeml as codeml_app
from paml_tpu.core import pruning
from paml_tpu.core.topology import from_treenode
from paml_tpu.io import seqio, treeio
from paml_tpu.models.codon import codon_graph
from paml_tpu.parallel.sharding import (data_mesh, pad_patterns, replicate,
                                        shard_data)

# 7 taxa, unrooted (trifurcating root), branch lengths as starting values
TREE7 = ("((t0: 0.10, t1: 0.20): 0.12, (t2: 0.05, (t3: 0.30, t4: 0.15): "
         "0.08): 0.10, (t5: 0.22, t6: 0.04): 0.06);")


def _seeded_data(nstates, npatt, seed, seqtype):
    """Random one-hot alignment patterns on TREE7 (npatt deliberately not
    a multiple of the mesh size, so shard_data pads)."""
    rng = np.random.default_rng(seed)
    names = [f"t{i}" for i in range(7)]
    states = rng.integers(0, nstates, size=(7, npatt))
    tips = np.zeros((7, npatt, nstates))
    tips[np.arange(7)[:, None], np.arange(npatt)[None, :], states] = 1.0
    fpatt = rng.integers(1, 5, size=npatt).astype(np.float64)
    data = seqio.PackedData(
        names=names, seqtype=seqtype, nstates=nstates, tip_partials=tips,
        fpatt=fpatt, ls=int(fpatt.sum()), posG=np.array([0, npatt]),
        base_freqs=tips.sum((0, 1)) / tips.sum())
    topo = from_treenode(treeio.parse_newick(TREE7), names)
    return data, topo


def _codon_data(seed=1, npatt=61):
    return _seeded_data(codon_graph(0).n, npatt, seed, seqtype=1)


def _mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return data_mesh(jax.devices()[:8])


def test_codon_lnl_sharded_equals_replicated():
    data, topo = _codon_data(seed=1)
    spec = codeml_app.CodemlSpec(NSsites=3, ncatG=3, cleandata=True)
    neg_lnl, unpack, classes_for, x0, bounds, pi = \
        codeml_app.make_codon_objective(data, topo, spec)
    x = jnp.asarray(x0)
    v_rep = float(jax.jit(neg_lnl)(x))

    mesh = _mesh()
    tips_s, fpatt_s = shard_data(mesh, data.tip_partials, data.fpatt)
    xs = replicate(mesh, x)
    with mesh:
        v_shard = float(jax.jit(neg_lnl.with_data)(xs, tips_s, fpatt_s))
    assert abs(v_shard - v_rep) <= 1e-6 * max(1.0, abs(v_rep))


def test_codon_grad_sharded_equals_replicated():
    data, topo = _codon_data(seed=2)
    spec = codeml_app.CodemlSpec(cleandata=True)
    neg_lnl, *_r = codeml_app.make_codon_objective(data, topo, spec)
    x0 = _r[2]
    x = jnp.asarray(x0)
    g_rep = np.asarray(jax.jit(jax.grad(neg_lnl))(x))

    mesh = _mesh()
    tips_s, fpatt_s = shard_data(mesh, data.tip_partials, data.fpatt)
    xs = replicate(mesh, x)
    with mesh:
        g_sh = np.asarray(jax.jit(jax.grad(
            lambda p: neg_lnl.with_data(p, tips_s, fpatt_s)))(xs))
    np.testing.assert_allclose(g_sh, g_rep, rtol=1e-9, atol=1e-9)


def test_pad_patterns_is_exact():
    rng = np.random.default_rng(0)
    tp = rng.uniform(0, 1, size=(5, 13, 4))
    fp = rng.integers(1, 9, size=13).astype(float)
    tp2, fp2 = pad_patterns(tp, fp, 8)
    assert tp2.shape[1] == 16 and fp2.shape[0] == 16
    assert (fp2[13:] == 0).all() and (tp2[:, 13:, :] == 1).all()


def test_baseml_lnl_sharded_equals_replicated():
    data, topo = _seeded_data(4, 45, seed=3, seqtype=0)
    spec = baseml_app.BasemlSpec(model="HKY85", cleandata=True)
    neg_lnl, unpack, x0, bounds = baseml_app.make_objective(data, topo, spec)
    x = jnp.asarray(np.asarray(x0, float))
    v_rep = float(jax.jit(neg_lnl)(x))

    if not hasattr(neg_lnl, "with_data"):
        pytest.skip("baseml objective lacks with_data")
    mesh = _mesh()
    tips_s, fpatt_s = shard_data(mesh, data.tip_partials, data.fpatt)
    xs = replicate(mesh, x)
    with mesh:
        v_shard = float(jax.jit(neg_lnl.with_data)(xs, tips_s, fpatt_s))
    assert abs(v_shard - v_rep) <= 1e-6 * max(1.0, abs(v_rep))


# ---------------------------------------------------------------------------
# pruning under set_pattern_mesh (shard_map over the pattern axis)
# ---------------------------------------------------------------------------


def _random_codon_problem(ns=9, H=256, C=3, n=61, seed=0):
    rng = np.random.default_rng(seed)
    names = [f"t{i}" for i in range(ns)]

    def bal(lo, hi):
        if hi - lo == 1:
            return names[lo]
        m = (lo + hi) // 2
        return f"({bal(lo, m)},{bal(m, hi)})"
    mid1, mid2 = ns // 3, 2 * ns // 3
    nwk = f"({bal(0, mid1)},{bal(mid1, mid2)},{bal(mid2, ns)});"
    topo = from_treenode(treeio.parse_newick(nwk), names)
    P = rng.gamma(1.0, 1.0, size=(topo.nnode, C, n, n))
    P = P / P.sum(axis=-1, keepdims=True)
    P = 0.7 * np.eye(n)[None, None] + 0.3 * P
    pi = rng.dirichlet(np.ones(n), size=C)
    tips = rng.integers(0, n, size=(ns, H)).astype(np.int32)
    return jnp.asarray(P), jnp.asarray(tips), topo, jnp.asarray(pi)


def _on_mesh(fn):
    pruning.set_pattern_mesh(_mesh())
    try:
        return fn()
    finally:
        pruning.set_pattern_mesh(None)


def test_pattern_mesh_lnf_equals_replicated():
    """class_site_lnf shard_mapped over the 8-device pattern mesh must
    equal the replicated value (per-pattern work is independent)."""
    P, tips, topo, pi = _random_codon_problem(seed=11)
    ref = np.asarray(pruning.class_site_lnf(P, tips, topo, pi))
    got = np.asarray(_on_mesh(
        lambda: pruning.class_site_lnf(P, tips, topo, pi)))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_pattern_mesh_grad_equals_replicated():
    P, tips, topo, pi = _random_codon_problem(ns=7, H=128, C=2, seed=12)
    w = jnp.asarray(np.random.default_rng(3).uniform(0.5, 2.0, size=128))

    def obj(P_, pi_):
        return jnp.sum(w * jnp.sum(
            pruning.class_site_lnf(P_, tips, topo, pi_), axis=0))

    vr, (gPr, gpir) = jax.value_and_grad(obj, argnums=(0, 1))(P, pi)
    vp, (gPp, gpip) = _on_mesh(
        lambda: jax.value_and_grad(obj, argnums=(0, 1))(P, pi))
    np.testing.assert_allclose(float(vp), float(vr), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(gPp), np.asarray(gPr),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(gpip), np.asarray(gpir),
                               rtol=1e-9, atol=1e-9)
