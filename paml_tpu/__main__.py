"""Command-line front end with reference-compatible control files.

Usage:
  python -m paml_tpu baseml  [baseml.ctl]
  python -m paml_tpu basemlg [baseml.ctl]     # continuous-gamma rates
  python -m paml_tpu pamp    [pamp.ctl]       # parsimony rate analysis
  python -m paml_tpu codeml  [codeml.ctl]
  python -m paml_tpu yn00    [yn00.ctl]
  python -m paml_tpu chi2    [df stat]        # LRT p-values (reference chi2)
  python -m paml_tpu evolver <mode> <args>    # 1-4 trees, 5-7 simulate,
                                              # 8 distances, 9 clade
                                              # support, 11 label clades
  python -m paml_tpu mcmctree [ctl | --combine out in1 in2 ...]
  python -m paml_tpu infinitesites [mcmctree.ctl]  # infinite-sites dating
  python -m paml_tpu ds      <samplefile>     # descriptive statistics
  python -m paml_tpu bfdriver <ctl> [nbeta]   # marginal-likelihood driver
  python -m paml_tpu multiruns <out> <rst1 files...>

Mirrors the reference programs' invocation (e.g. `codeml codeml.ctl`);
default ctl names match the reference (codeml.ctl, baseml.ctl, yn00.ctl).
"""
from __future__ import annotations

import sys
import time


def _fit_note(res, t0: float) -> str:
    """'(N evaluations, T s)' for a finished fit started at t0."""
    n = res.fit.n_eval if res.fit is not None else 0
    return f"({n} evaluations, {time.perf_counter() - t0:.2f} s)"


def _write_tree_with_blens(topo, blens_by_node, names=True):
    from .io.treeio import TreeNode

    def build(i: int) -> str:
        kids = [c for c in topo.children[i] if c >= 0]
        if not kids:
            label = topo.node_names[i] if names else str(i + 1)
        else:
            label = "(" + ", ".join(build(c) for c in kids) + ")"
        if i in blens_by_node:
            label += f": {blens_by_node[i]:.6f}"
        return label

    return build(topo.root) + ";"


def run_baseml(ctl_path: str) -> None:
    import jax

    jax.config.update("jax_enable_x64", True)
    from .apps import baseml
    from .io import ctl as ctlmod
    from .io import seqio, treeio
    from .core.topology import from_treenode

    opts = ctlmod.read_ctl(ctl_path)
    spec, seqfile, treefile, outfile, extras = ctlmod.baseml_spec(opts, ctl_path)
    if extras["clock"] in (5, 6):
        # heterogeneous multi-locus dating (reference: DatingHeteroData,
        # src/treesub.c:10100)
        from .apps import clock56
        spec56 = clock56.Clock56Spec(
            model=spec.model, clock=extras["clock"],
            fix_kappa=spec.fix_kappa,
            kappa=[float(v) for v in str(opts.get("kappa", "2")).split()],
            fix_alpha=spec.fix_alpha,
            alpha=[float(v) for v in str(opts.get("alpha", "0")).split()],
            ncatG=spec.ncatG, cleandata=spec.cleandata, getSE=spec.getSE)
        res = clock56.fit(treefile, seqfile, extras["ndata"], spec56)
        with open(outfile, "w") as out:
            out.write(f"BASEML (paml_tpu) clock = {extras['clock']} "
                      f"({extras['ndata']} loci)\n")
            out.write(f"lnL = {res.lnL:.6f}   np = {res.np}\n\nNode ages:\n")
            st = res.sp_topo
            for n in range(st.ns, st.nnode):
                out.write(f"  node {n + 1}: {res.ages[n]:.6f}\n")
            out.write("\nSubstitution rates for genes (per time unit)\n")
            for g, r in enumerate(res.rates):
                out.write(f"  Gene {g + 1}: "
                          + " ".join(f"{v:.5f}" for v in r) + "\n")
            if res.kappa is not None:
                out.write("\nkappa for genes\n  "
                          + " ".join(f"{v:.5f}" for v in res.kappa.ravel())
                          + "\n")
            if res.alpha is not None:
                out.write("\nalpha for genes\n  "
                          + " ".join(f"{v:.5f}" for v in res.alpha) + "\n")
            if res.SEs is not None:
                out.write("\nSEs:\n  "
                          + " ".join(f"{v:.5f}" for v in res.SEs) + "\n")
        print(f"lnL = {res.lnL:.6f}; results written to {outfile}")
        return
    import numpy as np

    from .io.outputs import (write_lnf, write_rates, write_rst1,
                             write_rst_ancestral)

    aln = seqio.read_alignment(seqfile, seqio.BASE_SEQ)
    data = seqio.pack(aln, cleandata=spec.cleandata)
    runmode = extras.get("runmode", 0)
    if runmode in (2, 3, 4, 5):
        # tree search (reference: runmode 2 star decomposition, 3 stepwise
        # addition, 4/5 NNI perturbation; treesub.c:4642-5170)
        from .apps import treesearch

        def fit_fn(topo_, sub):
            return baseml.fit_packed(sub, topo_, spec).lnL

        if runmode == 3:
            tree, score = treesearch.stepwise_addition_ml(
                data, fit_fn, progress=True)
        elif runmode == 2:
            tree, score = treesearch.star_decomposition(
                data, lambda t_, d_: fit_fn(t_, d_), progress=True)
        else:
            start, _ = treesearch.stepwise_addition_mp(data)
            tree, score = treesearch.nni_search_ml(
                data, start, lambda t_: fit_fn(t_, data))
        with open(outfile, "w") as out:
            out.write(f"BASEML (paml_tpu) tree search runmode {runmode}\n")
            out.write(f"best lnL = {score:.6f}\n")
            out.write(treeio.write_newick(tree, branch_lengths=False)
                      + "\n")
        print(f"tree search done: lnL {score:.6f} -> {outfile}")
        return
    trees = treeio.read_trees(treefile, data.names)
    rate_ancestor = extras.get("RateAncestor", 0)
    site_lnf_trees = []
    open("rst1", "w").close()
    frst = open("rst", "w")
    frst.write(f"Supplemental results for BASEML (paml_tpu): {seqfile}\n")
    with open(outfile, "w") as out:
        out.write(f"BASEML (paml_tpu) {seqfile}  model {spec.model}\n")
        out.write(f"ns = {data.ns}  ls = {data.ls}  npatt = {data.npatt}\n")
        for itree, tree in enumerate(trees):
            topo = from_treenode(tree, data.names)
            t_fit = time.perf_counter()
            res = baseml.fit_packed(data, topo, spec)
            note = _fit_note(res, t_fit)
            bl = dict(zip(res.branch_nodes.tolist(), res.blens.tolist()))
            out.write(f"\nTREE # {itree + 1}\n")
            out.write(f"lnL(ntime: {len(res.blens)}  np: {res.np}): "
                      f"{res.lnL:.6f}\n")
            out.write(_write_tree_with_blens(res.topo, bl) + "\n")
            if res.rate_params.size:
                out.write("rate parameters: "
                          + " ".join(f"{v:.6f}" for v in res.rate_params) + "\n")
            if res.alpha is not None and not spec.nparK:
                out.write("alpha = "
                          + " ".join(f"{a:.5f}" for a in res.alpha) + "\n")
            if not spec.fix_rho:
                # AdG autocorrelation (reference: rho output,
                # src/baseml.c:806)
                out.write(f"rho (auto-discrete-gamma) = "
                          f"{float(res.x[-1]):.5f}\n")
            if spec.nparK:
                K = spec.ncatG
                n_extra = {1: 0, 2: K - 1, 3: (K - 1) * (K - 1),
                           4: K * (K - 1)}[spec.nparK]
                rk = res.x[len(res.x) - (K - 1) - n_extra:][:K - 1]
                out.write(f"nparK = {spec.nparK} free rates 1..K-1 "
                          f"(K = {K}; mean rate constrained to 1): "
                          + " ".join(f"{v:.5f}" for v in rk) + "\n")
            if (res.rgene.size > 1):
                out.write("rgene: "
                          + " ".join(f"{v:.5f}" for v in res.rgene) + "\n")
            if res.SEs is not None:
                out.write("SEs: " + " ".join(f"{v:.6f}" for v in res.SEs) + "\n")
            write_rst1("rst1", [res.lnL] + [float(v) for v in res.x],
                       append=True)
            if spec.nhomo:
                # nonhomogeneous fits report the per-set base frequencies
                # (reference: DetailOutput nhomo block, src/baseml.c:786)
                out.write("base frequency parameter sets (TCAG):\n")
                for k, p4 in enumerate(np.atleast_2d(res.pi)):
                    out.write(f"  set {k + 1}: "
                              + " ".join(f"{v:.5f}" for v in p4) + "\n")
                continue
            # side outputs when the single-gene hooks exist (one-shot
            # f64 evaluations)
            import jax.numpy as jnp
            neg, unpack, x0b, bb = baseml.make_objective(data, topo,
                                                         spec)
            xj = jnp.asarray(res.x)
            if hasattr(neg, "site_loglik"):
                site_lnf_trees.append(
                    np.asarray(neg.site_loglik(xj)))
            if (rate_ancestor and hasattr(neg, "class_posterior")
                    and itree == 0):
                post, r, w = neg.class_posterior(xj)
                if np.asarray(r).shape[0] > 1:
                    write_rates("rates", 0, np.asarray(r),
                                np.asarray(w), data.site_pattern,
                                np.asarray(post), data.fpatt)
                from .apps.ancestral import marginal_reconstruction
                P, piC, w2, _ = neg.model_at(xj)
                best, prob, _p = marginal_reconstruction(
                    P, data.tip_partials, topo, piC, w2, data.fpatt)
                letters = "TCAG"
                node_ids = [i + 1
                            for i in range(topo.ns, topo.nnode)]
                best_txt = [[letters[s] for s in row]
                            for row in best]
                write_rst_ancestral(frst, data.names, node_ids,
                                    best_txt, prob,
                                    data.site_pattern)
            print(f"tree {itree + 1}: lnL = {res.lnL:.6f}  {note}")
        if site_lnf_trees:
            write_lnf("lnf", data.ls, data.fpatt, site_lnf_trees)
        if len(site_lnf_trees) > 1:
            from .apps.bootstrap import tree_comparison
            stats = tree_comparison(np.stack(site_lnf_trees), data.fpatt)
            out.write("\nTree comparison (RELL / KH / SH)\n")
            out.write("tree    lnL-diff     pRELL      pKH      pSH\n")
            for i in range(len(site_lnf_trees)):
                out.write(f"{i + 1:4d} {stats['D'][i]:11.4f} "
                          f"{stats['pRELL'][i]:9.4f} {stats['pKH'][i]:8.4f}"
                          f" {stats['pSH'][i]:8.4f}\n")
    frst.close()
    print(f"results written to {outfile}")


def run_codeml(ctl_path: str) -> None:
    import jax

    jax.config.update("jax_enable_x64", True)
    from .apps import baseml  # noqa: F401  (shared config)
    from .apps import beb as bebmod
    from .apps import codeml
    from .io import ctl as ctlmod
    from .io import seqio, treeio
    from .io.outputs import (write_lnf, write_rst1, write_rst_ancestral,
                             write_rst_neb)
    from .core.topology import from_treenode

    import numpy as np

    opts = ctlmod.read_ctl(ctl_path)
    spec, seqfile, treefile, outfile, extras = ctlmod.codeml_spec(opts, ctl_path)
    from .core.optim import set_rub
    open("rub", "w").close()
    set_rub("rub")
    seqtype = (seqio.AA_SEQ if spec.seqtype == 2 else
               seqio.CODON2AA_SEQ if spec.seqtype == 3 else seqio.CODON_SEQ)
    ndata = extras.get("ndata", 1)
    if ndata > 1:
        # multiple data sets stacked in one seqfile (reference: the ndata
        # loop, src/codeml.c:372).  Tree handling per
        # examples/ndata/README.txt: shared tree block, per-dataset tree
        # blocks ('separate_trees'), or subtrees pruned from a main tree
        # ('maintree')
        mode = extras.get("ndata_mode", "shared")
        alns = seqio.read_alignments(seqfile, seqtype, ndata)
        tree_strs = treeio.read_tree_strings(treefile)
        main_tree = (treeio.parse_newick(tree_strs[0])
                     if mode == "maintree" else None)
        for i, a in enumerate(alns):
            print(f"\nData set {i + 1}")
            d = seqio.pack(a, cleandata=spec.cleandata, icode=spec.icode)
            if mode == "separate_trees":
                tree_i = treeio.parse_newick(tree_strs[i])
                treeio._resolve_names(tree_i, d.names)
            elif mode == "maintree":
                import copy
                tree_i = treeio.prune_to(copy.deepcopy(main_tree),
                                         d.names)
                treeio._resolve_names(tree_i, d.names)
            else:
                tree_i = treeio.read_trees(treefile, d.names)[0]
            topo_i = from_treenode(tree_i, d.names)
            res = (codeml.fit_aa_packed(d, topo_i, spec)
                   if spec.seqtype in (2, 3)
                   else codeml.fit_packed(d, topo_i, spec))
            fmode = "a" if i else "w"
            with open(outfile, fmode) as out:
                out.write(f"\nData set {i + 1}\n")
                out.write(f"lnL(ntime: {len(res.blens)}  np: {res.np}): "
                          f"{res.lnL:.6f}\n")
            from .io.outputs import write_rst1 as _w1
            _w1("rst1", [i + 1, res.lnL] + [float(v) for v in res.x],
                append=bool(i))
            print(f"lnL = {res.lnL:.6f}")
        print(f"results written to {outfile}")
        return
    aln = seqio.read_alignment(seqfile, seqtype)
    data = seqio.pack(aln, cleandata=spec.cleandata, icode=spec.icode)
    if extras.get("runmode", 0) in (-2, -3) and spec.seqtype == 1:
        # pairwise ML (-2) / Bayesian (-3) dN/dS without a tree
        # (reference: PairwiseCodon codeml.c:4344, BayesPairwise :4612;
        # 2ML.* matrices written like src/yn00.c:141-167)
        from .apps import pairwise as pw
        from .io.outputs import write_pairwise_matrix
        if extras["runmode"] == -2:
            res = pw.pairwise_codon(data, codonf=spec.codonf,
                                    icode=spec.icode,
                                    kappa0=spec.kappa,
                                    omega0=spec.omega,
                                    fix_kappa=spec.fix_kappa)
        else:
            res = pw.bayes_pairwise_codon(data, codonf=spec.codonf,
                                          icode=spec.icode,
                                          kappa0=spec.kappa,
                                          omega0=spec.omega)
        ns = data.ns
        mats = {q: np.zeros((ns, ns)) for q in ("t", "dS", "dN")}
        with open(outfile, "w") as out:
            out.write(f"CODEML (paml_tpu) pairwise runmode "
                      f"{extras['runmode']}\n")
            out.write("seq1 seq2        t    kappa    omega       dN"
                      "       dS\n")
            for r in res:
                t = getattr(r, "t", getattr(r, "t_mean", 0.0))
                w = getattr(r, "omega", getattr(r, "w_mean", 0.0))
                kap = getattr(r, "kappa", 0.0)
                dN = getattr(r, "dN", 0.0)
                dS = getattr(r, "dS", 0.0)
                mats["t"][r.i, r.j] = mats["t"][r.j, r.i] = t
                mats["dS"][r.i, r.j] = mats["dS"][r.j, r.i] = dS
                mats["dN"][r.i, r.j] = mats["dN"][r.j, r.i] = dN
                out.write(f"{r.i + 1:4d} {r.j + 1:4d} {t:8.4f} "
                          f"{kap:8.4f} {w:8.4f} {dN:8.4f} {dS:8.4f}\n")
        for q in ("t", "dS", "dN"):
            write_pairwise_matrix(f"2ML.{q}", data.names, mats[q])
        print(f"pairwise results written to {outfile} + 2ML.*")
        return
    if extras.get("runmode", 0) in (2, 3, 4, 5):
        # tree search under the codon/AA model (reference supports the
        # same runmodes in codeml: Forestry -> StepwiseAddition etc.,
        # src/codeml.c:606, src/treesub.c:4866)
        from .apps import treesearch
        runmode = extras["runmode"]

        def fit_fn(topo_, sub):
            return (codeml.fit_aa_packed(sub, topo_, spec).lnL
                    if spec.seqtype in (2, 3)
                    else codeml.fit_packed(sub, topo_, spec).lnL)

        if runmode == 3:
            tree, score = treesearch.stepwise_addition_ml(
                data, fit_fn, progress=True)
        elif runmode == 2:
            tree, score = treesearch.star_decomposition(
                data, lambda t_, d_: fit_fn(t_, d_), progress=True)
        else:
            start, _ = treesearch.stepwise_addition_mp(data)
            tree, score = treesearch.nni_search_ml(
                data, start, lambda t_: fit_fn(t_, data))
        with open(outfile, "w") as out:
            out.write(f"CODEML (paml_tpu) tree search runmode {runmode}\n")
            out.write(f"best lnL = {score:.6f}\n")
            out.write(treeio.write_newick(tree, branch_lengths=False)
                      + "\n")
        print(f"tree search done: lnL {score:.6f} -> {outfile}")
        return
    trees = treeio.read_trees(treefile, data.names)
    ns_list = extras["NSsites_list"] or [spec.NSsites]
    rate_ancestor = extras.get("RateAncestor", 0)
    import dataclasses
    site_lnf_trees = []          # per tree [npatt] (first NSsites model)
    frst = open("rst", "w")
    frst.write(f"Supplemental results for CODEML (paml_tpu): "
               f"{seqfile}\n")
    open("rst1", "w").close()                # truncate
    with open(outfile, "w") as out:
        out.write(f"CODEML (paml_tpu) {seqfile}\n")
        out.write(f"ns = {data.ns}  ls = {data.ls}  npatt = {data.npatt}\n")
        for ins, ns_model in enumerate(ns_list):
            sp = dataclasses.replace(spec, NSsites=ns_model)
            for itree, tree in enumerate(trees):
                topo = from_treenode(tree, data.names)
                t_fit = time.perf_counter()
                if sp.seqtype in (2, 3):
                    res = codeml.fit_aa_packed(data, topo, sp)
                else:
                    res = codeml.fit_packed(data, topo, sp)
                note = _fit_note(res, t_fit)
                bl = dict(zip(res.branch_nodes.tolist(), res.blens.tolist()))
                out.write(f"\nModel NSsites={ns_model}  TREE # {itree + 1}\n")
                out.write(f"lnL(ntime: {len(res.blens)}  np: {res.np}): "
                          f"{res.lnL:.6f}\n")
                out.write(_write_tree_with_blens(res.topo, bl) + "\n")
                if res.kappa.size:
                    out.write("kappa = "
                              + " ".join(f"{k:.5f}" for k in res.kappa) + "\n")
                if res.class_omegas is not None and sp.seqtype == 1:
                    out.write("omega classes: "
                              + np.array2string(res.class_omegas,
                                                precision=5) + "\n")
                    out.write("class freqs:   "
                              + np.array2string(res.class_freqs,
                                                precision=5) + "\n")
                write_rst1("rst1", [res.lnL] + [float(v) for v in res.x],
                           append=True)
                if (sp.seqtype == 1 and ns_model == 0 and not sp.aaDist
                        and sp.clock == 0 and sp.fix_blength != 2):
                    _write_branch_dnds(out, data, sp, res)
                # side outputs on the first NSsites model (reference
                # layout: one lnf per run; rst accumulates per model):
                # one-shot f64 evaluations at the MLE
                if sp.seqtype == 1 and not sp.aaDist:
                    neg, unpack, classes_for, *_r = \
                        codeml.make_codon_objective(data, topo, sp)
                    import jax.numpy as jnp
                    xj = jnp.asarray(res.x)
                    if ins == 0:
                        site_lnf_trees.append(
                            np.asarray(neg.site_loglik(xj)))
                    if sp.getSE:
                        ses = codeml.standard_errors(neg, res.x)
                        out.write("SEs for parameters:\n"
                                  + " ".join(f"{v:.5f}" for v in ses)
                                  + "\n")
                    if rate_ancestor and ns_model and sp.model == 0 \
                            and itree == 0:
                        post = np.asarray(neg.class_posterior(xj))
                        frst.write(f"\nModel NSsites={ns_model}\n")
                        write_rst_neb(frst, data.site_pattern, post,
                                      res.class_omegas.reshape(-1),
                                      data.fpatt)
                    if rate_ancestor and itree == 0:
                        _write_ancestral_rst(frst, data, topo, sp, neg,
                                             xj, res)
                if (sp.seqtype == 1 and sp.model == 2 and ns_model == 2
                        and itree == 0):
                    # branch-site model A BEB (reference:
                    # lfunNSsites_ACD, src/codeml.c:6827); f64 grid
                    acd = bebmod.beb_branchsite_A(data, topo, sp, res)
                    post = acd["postSite"]
                    frst.write("\nBayes Empirical Bayes (BEB) "
                               "probabilities for 4 classes "
                               "(branch-site model A)\n")
                    frst.write("site  class0   class1   class2a  "
                               "class2b\n")
                    for s_i, h in enumerate(data.site_pattern):
                        frst.write(f"{s_i + 1:5d}  "
                                   + "  ".join(f"{post[k, h]:.5f}"
                                               for k in range(4)) + "\n")
                    out.write("\nBayes Empirical Bayes (BEB) analysis "
                              "(Yang, Wong & Nielsen 2005)\n")
                    out.write("Positive sites for foreground lineages "
                              "Prob(w>1):\n")
                    for s_i, h in enumerate(data.site_pattern):
                        pp = acd["pos_prob"][h]
                        if pp > 0.5:
                            sig = ("**" if pp > 0.99 else
                                   "*" if pp > 0.95 else "")
                            out.write(f"{s_i + 1:6d} {pp:.3f}{sig}\n")
                if (sp.seqtype == 1 and sp.model == 0
                        and ns_model in (2, 8) and itree == 0):
                    spbeb = bebmod.beb(data, topo, sp, res)
                    sites = bebmod.positive_sites(data, spbeb, 0.5)
                    out.write("BEB positively selected sites "
                              "(P>0.5; * P>0.95, ** P>0.99):\n")
                    frst.write(f"\nBayes Empirical Bayes (BEB) "
                               f"probabilities, NSsites={ns_model}\n")
                    for s, p, w in sites:
                        h = data.site_pattern[s - 1]
                        star = ("**" if p > 0.99 else
                                "*" if p > 0.95 else "")
                        line = (f"  {s:5d}  {p:.3f}{star:2s}  "
                                f"{w:.3f} +- {spbeb.se_w[h]:.3f}\n")
                        out.write(line)
                        frst.write(line)
                print(f"NSsites={ns_model} tree {itree + 1}: "
                      f"lnL = {res.lnL:.6f}  {note}")
        # lnf + RELL/KH/SH tree comparison over trees (reference:
        # src/codeml.c:623-689 + rell, src/treesub.c:5844)
        if site_lnf_trees:
            write_lnf("lnf", data.ls, data.fpatt, site_lnf_trees)
        if len(site_lnf_trees) > 1:
            from .apps.bootstrap import tree_comparison
            stats = tree_comparison(np.stack(site_lnf_trees), data.fpatt)
            out.write("\nTree comparison (RELL / KH / SH)\n")
            out.write("tree    lnL-diff     pRELL      pKH      pSH\n")
            for i in range(len(site_lnf_trees)):
                out.write(f"{i + 1:4d} {stats['D'][i]:11.4f} "
                          f"{stats['pRELL'][i]:9.4f} {stats['pKH'][i]:8.4f}"
                          f" {stats['pSH'][i]:8.4f}\n")
    frst.close()
    print(f"results written to {outfile}")


def _write_branch_dnds(out, data, sp, res) -> None:
    """'dN & dS for each branch' table (reference: DetailOutput via
    eigenQcodon mode=2, src/codeml.c:3357-3377)."""
    import numpy as np

    from .models import codon as codonmod

    graph = codonmod.codon_graph(sp.icode)
    import jax.numpy as jnp
    fcodon, f3x4, f1x4 = codonmod.count_codon_freqs(
        data.tip_partials, data.fpatt, graph, data.pos_masks)
    pf3x4 = codonmod.mg_pf3x4(sp.codonf, f3x4, f1x4)
    kap = (res.kappa if sp.hkyREV else float(res.kappa[0])) \
        if res.kappa.size else sp.kappa
    pi = jnp.asarray(res.pi)
    if sp.codonf in ("FMutSel", "FMutSel0"):
        pf = jnp.asarray(res.params["pf_TCAG"])
        s = codonmod.mutation_part(graph, kap,
                                   np.tile(np.asarray(pf)[None], (3, 1)),
                                   sp.hkyREV)
        s = s * codonmod.fmutsel_multiplier(graph, pf, pi, data.ls)
    else:
        s = codonmod.mutation_part(graph, kap, pf3x4, sp.hkyREV)
    W = res.class_omegas
    topo = res.topo
    out.write("\ndN & dS for each branch\n")
    out.write(f"{'branch':>10s} {'t':>8s} {'N':>9s} {'S':>9s} "
              f"{'dN/dS':>8s} {'dN':>8s} {'dS':>8s}\n")
    labels = topo.labels
    for bi, node in enumerate(res.branch_nodes):
        if W.shape[0] > 1:
            btype = (bi if sp.model == 1 else int(labels[node]))
            w = float(W[min(btype, W.shape[0] - 1), 0])
        else:
            w = float(W[0, 0])
        st_ = codonmod.branch_dnds(graph, s, pi, w,
                                   float(res.blens[bi]), data.ls)
        par = int(topo.parent[node]) + 1
        out.write(f"{par:>5d}..{node + 1:<4d}{st_['t']:8.3f} "
                  f"{st_['N']:9.1f} {st_['S']:9.1f} {st_['w']:8.4f} "
                  f"{st_['dN']:8.4f} {st_['dS']:8.4f}\n")


def _write_ancestral_rst(frst, data, topo, sp, neg, xj, res) -> None:
    """Marginal ancestral reconstruction into rst (reference:
    AncestralMarginal, src/treesub.c:6288)."""
    from .apps.ancestral import marginal_reconstruction
    from .constants import codon_string
    from .io.outputs import write_rst_ancestral
    from .models.codon import codon_graph

    P, piC, freqs = neg.model_at(xj)
    best, prob, _post = marginal_reconstruction(
        P, data.tip_partials, topo, piC, freqs, data.fpatt)
    graph = codon_graph(sp.icode)
    codons = [codon_string(int(c)) for c in graph.sense]
    node_ids = [i + 1 for i in range(topo.ns, topo.nnode)]
    best_txt = [[codons[s] for s in row] for row in best]
    write_rst_ancestral(frst, data.names, node_ids, best_txt, prob,
                        data.site_pattern)


def run_yn00(ctl_path: str) -> None:
    import jax

    jax.config.update("jax_enable_x64", True)
    from .apps import yn00
    from .io import ctl as ctlmod

    import numpy as np

    from .io.outputs import write_pairwise_matrix
    from .io.seqio import read_alignment

    opts = ctlmod.yn00_opts(ctlmod.read_ctl(ctl_path), ctl_path)
    ndata = opts.get("ndata", 1)
    if ndata > 1:
        # multiple stacked data sets (reference: the yn00 ndata loop)
        from .io import seqio as _seqio
        alns = _seqio.read_alignments(opts["seqfile"], _seqio.CODON_SEQ,
                                      ndata)
        with open(opts["outfile"], "w") as out:
            out.write("YN00 (paml_tpu)\n")
            for i, a in enumerate(alns):
                d = _seqio.pack(a, cleandata=True, icode=opts["icode"])
                rs = yn00.run_packed(d, icode=opts["icode"],
                                     weighting=opts["weighting"],
                                     common_f3x4=opts["common_f3x4"])
                out.write(f"\nData set {i + 1}\n")
                for r in rs:
                    out.write(f"{r.i + 1:4d}{r.j + 1:4d} {r.t:8.4f}"
                              f"{r.kappa:8.4f}{r.omega:8.4f} "
                              f"{r.dN:7.4f} {r.dS:7.4f}\n")
        print(f"{ndata} data sets written to {opts['outfile']}")
        return
    results = yn00.run(opts["seqfile"], icode=opts["icode"],
                       weighting=opts["weighting"],
                       common_f3x4=opts["common_f3x4"])
    # 2YN./2NG. lower-triangle matrices (reference: src/yn00.c:141-167)
    names = read_alignment(opts["seqfile"], 1).names
    ns = len(names)
    mats = {k: np.zeros((ns, ns)) for k in
            ("YN_dS", "YN_dN", "YN_t", "NG_dS", "NG_dN", "NG_t")}
    for r in results:
        mats["YN_dS"][r.i, r.j] = mats["YN_dS"][r.j, r.i] = r.dS
        mats["YN_dN"][r.i, r.j] = mats["YN_dN"][r.j, r.i] = r.dN
        mats["YN_t"][r.i, r.j] = mats["YN_t"][r.j, r.i] = r.t
        mats["NG_dS"][r.i, r.j] = mats["NG_dS"][r.j, r.i] = r.ng_dS
        mats["NG_dN"][r.i, r.j] = mats["NG_dN"][r.j, r.i] = r.ng_dN
        mats["NG_t"][r.i, r.j] = mats["NG_t"][r.j, r.i] = \
            getattr(r, "ng_t", 0.0)
    for pre, tag in (("2YN", "YN"), ("2NG", "NG")):
        for q in ("dS", "dN", "t"):
            write_pairwise_matrix(f"{pre}.{q}", names, mats[f"{tag}_{q}"])
    with open(opts["outfile"], "w") as out:
        out.write("YN00 (paml_tpu)\n\n")
        out.write("Nei & Gojobori 1986. dN/dS (dN, dS)\n")
        for r in results:
            out.write(f"{r.i + 1:4d} vs {r.j + 1:4d}: "
                      f"{r.ng_dN / r.ng_dS if r.ng_dS > 0 else -1:.4f} "
                      f"({r.ng_dN:.4f} {r.ng_dS:.4f})\n")
        out.write("\nYang & Nielsen (2000)\n")
        out.write("seq seq      S       N      t    kappa   omega   "
                  "dN +- SE     dS +- SE\n")
        for r in results:
            out.write(f"{r.i + 1:4d}{r.j + 1:4d} {r.S:8.1f}{r.N:8.1f}"
                      f"{r.t:8.4f}{r.kappa:8.4f}{r.omega:8.4f} "
                      f"{r.dN:7.4f} +- {r.SEdN:6.4f} "
                      f"{r.dS:7.4f} +- {r.SEdS:6.4f}\n")
        out.write("\nLWL85 family\n")
        for r in results:
            l = r.lwl
            out.write(f"{r.i + 1:4d} vs {r.j + 1:4d}  "
                      f"LWL85 dS {l['LWL85']['dS']:.4f} dN {l['LWL85']['dN']:.4f}  "
                      f"LWL85m dS {l['LWL85m']['dS']:.4f} dN {l['LWL85m']['dN']:.4f}  "
                      f"LPB93 dS {l['LPB93']['dS']:.4f} dN {l['LPB93']['dN']:.4f}\n")
    print(f"results written to {opts['outfile']}")


def run_basemlg(ctl_path: str) -> None:
    """basemlg: ML under continuous-gamma rates (reference:
    src/basemlg.c:82; same ctl format as baseml)."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import dataclasses

    import numpy as np

    from .apps import baseml
    from .core.topology import from_treenode
    from .io import ctl as ctlmod
    from .io import seqio, treeio

    opts = ctlmod.read_ctl(ctl_path)
    spec, seqfile, treefile, outfile, extras = \
        ctlmod.baseml_spec(opts, ctl_path)
    # continuous gamma always estimates alpha unless fixed at a positive
    # value (reference: basemlg's com.alpha handling, src/basemlg.c:141)
    spec = dataclasses.replace(
        spec, continuous_gamma=True,
        fix_alpha=bool(spec.fix_alpha) and spec.alpha > 0)
    aln = seqio.read_alignment(seqfile, seqio.BASE_SEQ)
    data = seqio.pack(aln, cleandata=spec.cleandata)
    if data.ns > 10:
        print(f"warning: basemlg is meant for small trees "
              f"(ns = {data.ns} > 10; reference limit src/basemlg.c:14)")
    trees = treeio.read_trees(treefile, data.names)
    with open(outfile, "w") as out:
        out.write(f"BASEMLG (paml_tpu) {seqfile}  model {spec.model} "
                  f"(continuous gamma)\n")
        for itree, tree in enumerate(trees):
            topo = from_treenode(tree, data.names)
            res = baseml.fit_packed(data, topo, spec)
            bl = dict(zip(res.branch_nodes.tolist(), res.blens.tolist()))
            out.write(f"\nTREE # {itree + 1}\n")
            out.write(f"lnL(ntime: {len(res.blens)}  np: {res.np}): "
                      f"{res.lnL:.6f}\n")
            out.write(_write_tree_with_blens(res.topo, bl) + "\n")
            if res.rate_params.size:
                out.write("rate parameters: "
                          + " ".join(f"{v:.6f}" for v in res.rate_params)
                          + "\n")
            if res.alpha is not None:
                out.write(f"alpha (continuous gamma) = "
                          f"{float(res.alpha[0]):.6f}\n")
            if extras.get("RateAncestor") and itree == 0:
                rr = baseml.rho_rate(data, topo, spec, res.x)
                out.write(f"rate-variance decomposition: Vr {rr['Vr']:.6f}"
                          f"  PEV {rr['PEV']:.6f}  RHO {rr['RHO']:.6f}\n")
                with open("rates", "w") as fr:
                    fr.write("site  rate (posterior mean, continuous "
                             "gamma)\n")
                    rh = rr["rates"]
                    for s, h in enumerate(data.site_pattern):
                        fr.write(f"{s + 1:6d}  {rh[h]:9.5f}\n")
            print(f"tree {itree + 1}: lnL = {res.lnL:.6f}")
    print(f"results written to {outfile}")


def run_pamp(ctl_path: str) -> None:
    """pamp: parsimony-based rate analysis (reference: src/pamp.c:67;
    ctl template examples/pamp.ctl)."""
    from .apps import pamp
    from .io import ctl as ctlmod

    opts = ctlmod.read_ctl(ctl_path)
    g = lambda k, d=None: opts.get(k, d)
    seqfile = ctlmod.resolve_path(ctl_path, g("seqfile"))
    treefile = ctlmod.resolve_path(ctl_path, g("treefile"))
    outfile = g("outfile", "mp")
    ncatG = int(ctlmod._first_num(g("ncatG", "8")))
    res = pamp.run(seqfile, treefile, ncatG=ncatG)
    with open(outfile, "w") as out:
        out.write(f"PAMP (paml_tpu) {seqfile}\n\n")
        out.write("# changes (parsimony) histogram: sites with k "
                  "changes\n")
        for k, c in enumerate(res.n_changes_hist):
            if c:
                out.write(f"  {k:3d}: {c:.0f}\n")
        out.write(f"\nmean changes {res.mean:.4f}  variance "
                  f"{res.var:.4f}\n")
        out.write(f"alpha (method of moments)    = {res.alpha_mm:.5f}\n")
        out.write(f"alpha (Sullivan et al. 1995) = "
                  f"{res.alpha_sullivan:.5f}\n")
        out.write(f"alpha (Yang & Kumar 1996)    = {res.alpha_yk96:.5f}\n")
        if res.pattern_matrix is not None:
            out.write("\nsubstitution pattern matrix (parsimony counts, "
                      "TCAG):\n")
            for row in res.pattern_matrix:
                out.write("  " + " ".join(f"{v:9.2f}" for v in row)
                          + "\n")
    print(f"alpha estimates: MM {res.alpha_mm:.5f}  Sullivan "
          f"{res.alpha_sullivan:.5f}  YK96 {res.alpha_yk96:.5f}")
    print(f"results written to {outfile}")


def run_chi2(args: list[str]) -> None:
    """LRT chi-square p-values (reference: src/chi2.c)."""
    from scipy.stats import chi2 as chi2_dist
    if len(args) >= 2:
        df, stat = int(args[0]), float(args[1])
        p = chi2_dist.sf(stat, df)
        print(f"df = {df}  prob = {p:.9g} = {p:.6e}")
    else:
        # critical value table like the reference's interactive mode
        print("df      0.950    0.990    0.999")
        for df in list(range(1, 11)) + [20, 50, 100]:
            row = "  ".join(f"{chi2_dist.isf(a, df):8.4f}"
                            for a in (0.05, 0.01, 0.001))
            print(f"{df:3d}  {row}")


def _init_jax_backend(want_accel: bool = False) -> None:
    """Pick the CLI compute device.

    The ML fit programs (codeml/baseml/basemlg) run on JAX's default
    backend: the GPU when one is present, otherwise the CPU.  A GPU that
    is present but fails to start is an error, not a silent switch to the
    CPU.  Programs driven by host-side loops of small steps (mcmctree,
    yn00, evolver, pamp, ...) pin to the CPU, where each step costs no
    device dispatch.  PAML_TPU_CLI_DEVICE=cpu pins every program to the
    CPU."""
    import os

    import jax

    dev = os.environ.get("PAML_TPU_CLI_DEVICE", "auto").lower()
    if dev not in ("auto", "cpu"):
        raise ValueError(f"PAML_TPU_CLI_DEVICE={dev!r}: expected auto or cpu")
    if dev == "cpu" or not want_accel:
        jax.config.update("jax_platforms", "cpu")
    jax.devices()


def main(argv: list[str] | None = None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return
    prog = argv[0]
    _init_jax_backend(want_accel=prog in ("codeml", "baseml", "basemlg"))
    if prog in ("codeml", "baseml", "basemlg"):
        # multi-device hosts: shard the pattern axis across all chips
        # (single-device hosts: no-op)
        from .parallel.sharding import engage_auto_mesh
        engage_auto_mesh()
    prog, *rest = argv
    if prog == "baseml":
        run_baseml(rest[0] if rest else "baseml.ctl")
    elif prog == "basemlg":
        run_basemlg(rest[0] if rest else "baseml.ctl")
    elif prog == "pamp":
        run_pamp(rest[0] if rest else "pamp.ctl")
    elif prog == "codeml":
        run_codeml(rest[0] if rest else "codeml.ctl")
    elif prog == "yn00":
        run_yn00(rest[0] if rest else "yn00.ctl")
    elif prog == "chi2":
        run_chi2(rest)
    elif prog == "evolver":
        from .apps.evolver import main as evolver_main
        evolver_main(rest)
    elif prog == "mcmctree":
        from .apps.mcmctree import main as mcmctree_main
        mcmctree_main(rest)
    elif prog == "infinitesites":
        from .apps.infinitesites import run_ctl as is_run
        from .io.ctl import read_ctl
        ctl = rest[0] if rest else "mcmctree.ctl"
        out = is_run(read_ctl(ctl), ctl, progress=True)
        if isinstance(out, dict):            # clock 1
            lo, hi = out["t0_CI"]
            print(f"\nPosterior root age t0: mean {out['t0_mean']:.6f} "
                  f"95% CI ({lo:.6f}, {hi:.6f})")
            for lab in ("mean", "low", "high"):
                ages = out["times"][lab]
                print(f"{lab:>5s} times: "
                      + " ".join(f"{a:.6f}" for a in ages))
        else:                                # clock 2/3 sample list
            from .apps.mcmctree import summarize
            summ = summarize(out)
            print(f"{'param':>12s} {'mean':>10s} {'2.5%':>10s} "
                  f"{'97.5%':>10s}")
            for k, v in summ.items():
                print(f"{k:>12s} {v['mean']:10.5f} {v['eq_lo']:10.5f} "
                      f"{v['eq_hi']:10.5f}")
    elif prog == "ds":
        from .apps.mcmcutils import describe_file
        stats = describe_file(rest[0])
        print(f"{'param':>12s} {'mean':>10s} {'sd':>10s} {'median':>10s} "
              f"{'2.5%':>10s} {'97.5%':>10s} {'ESS':>8s}")
        for k, v in stats.items():
            print(f"{k:>12s} {v['mean']:10.4f} {v['sd']:10.4f} "
                  f"{v['median']:10.4f} {v['eq_lo']:10.4f} "
                  f"{v['eq_hi']:10.4f} {v['ess']:8.1f}")
    elif prog == "bfdriver":
        from .apps.mcmcutils import bfdriver
        nb = int(rest[1]) if len(rest) > 1 else 8
        betas, ws = bfdriver(rest[0], nbeta=nb)
        print(f"wrote {nb} per-beta configs under bf/ + runbf.sh")
    elif prog == "multiruns":
        from .apps.mcmcutils import multiruns
        n = multiruns(rest[1:], rest[0])
        print(f"merged {len(rest) - 1} runs, {n} datasets -> {rest[0]}")
    else:
        print(f"unknown program {prog!r}\n{__doc__}")
        sys.exit(2)


if __name__ == "__main__":
    main()
