"""Append the 'large-alignment' row to BENCH_EXAMPLES.json: a 32-taxon x
4096-pattern codon M3 fit (the bench.py primary shape), CPU-f64 vs the
staged policy on the default device (a GPU when present).  The
per-example rows are 7-25-taxon datasets with tens-to-hundreds of
patterns, where host tracing and dispatch dominate; this row is the
larger shape.

Usage: python tools/bench_bigrow.py
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    from paml_tpu.core.optim import maximize, maximize_policy
    from paml_tpu.apps.codeml import CodemlSpec, make_codon_objective
    from paml_tpu.core.topology import from_treenode
    from paml_tpu.io import seqio, treeio
    from paml_tpu.models.codon import codon_graph

    rng = np.random.default_rng(1)
    graph = codon_graph(0)
    ns, npatt = 32, 4096
    names = [f"t{i}" for i in range(ns)]
    nwk = names[0]
    for nm in names[1:-1]:
        nwk = f"({nwk}, {nm})"
    nwk = f"({nwk}, {names[-1]});"
    tree = treeio.parse_newick(nwk)
    for node in tree.walk_post():
        node.blen = float(rng.uniform(0.02, 0.3))
    topo = from_treenode(tree, names)
    states = rng.integers(0, graph.n, size=(ns, npatt))
    tips = np.zeros((ns, npatt, graph.n))
    tips[np.arange(ns)[:, None], np.arange(npatt)[None, :], states] = 1.0
    fpatt = rng.integers(1, 6, size=npatt).astype(np.float64)
    data = seqio.PackedData(
        names=names, seqtype=1, nstates=graph.n, tip_partials=tips,
        fpatt=fpatt, ls=int(fpatt.sum()), posG=np.array([0, npatt]),
        base_freqs=np.full(graph.n, 1 / graph.n))
    spec = CodemlSpec(NSsites=3, codonf="Fequal", cleandata=True)

    def make(dtype):
        neg_d, _u, _c, x0_d, bounds_d, _pi = make_codon_objective(
            data, topo, spec, dtype=dtype)
        return neg_d, np.asarray(x0_d, np.float64), bounds_d

    row = {}
    cpu = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    with jax.default_device(cpu):
        neg64, x064, bounds = make(jnp.float64)
        r = maximize(neg64, x064, bounds)
    row["ours"] = dict(wall_s=round(time.perf_counter() - t0, 2),
                       lnL=round(r.lnL, 4), n_eval=r.n_eval)
    if any(d.platform != "cpu" for d in jax.devices()):
        t0 = time.perf_counter()
        rt = maximize_policy(make)
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        rt = maximize_policy(make)
        row["ours_gpu"] = dict(wall_s=round(time.perf_counter() - t0, 2),
                               wall_cold_s=round(cold, 2),
                               lnL=round(rt.lnL, 4), n_eval=rt.n_eval)
    out = {}
    if os.path.exists("BENCH_EXAMPLES.json"):
        out = json.load(open("BENCH_EXAMPLES.json"))
    out["codeml_M3_32tax_4096patt_synthetic"] = row
    with open("BENCH_EXAMPLES.json", "w") as f:
        json.dump(out, f, indent=1)
    print("large-alignment row:", row)


if __name__ == "__main__":
    main()
