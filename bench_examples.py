"""Wall-time-to-converged-lnL on the BASELINE.json example configurations.

Runs the five benchmark configurations from BASELINE.md on this machine,
for BOTH this framework and (when available at /tmp/pamlbuild) the
reference C binaries, and writes BENCH_EXAMPLES.json:

  1. baseml JC69 + K80 on examples/brown.nuc (7 taxa, 895 sites)
  2. baseml GTR(REV)+G5 on examples/horai.nuc
  3. codeml M0 (F3x4) on examples/abglobin.nuc
  4. codeml NSsites M1a/M2a/M7/M8 + branch-site A on examples/lysozyme
  5. mcmctree approximate-likelihood dating on examples/DatingSoftBound
     (usedata=2 via autodiff in.BV; chain throughput iterations/s)

Each row records wall seconds, lnL, and the objective-evaluation counter
(the NFunCall analog, reference src/codeml.c:770) for parity-of-effort.

Usage: python bench_examples.py [--no-reference]
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REF = "/root/reference/examples"
REFBIN = "/tmp/pamlbuild/src"


def _setup_jax():
    import jax
    jax.config.update("jax_enable_x64", True)


def _cpu():
    import jax
    return jax.default_device(jax.devices("cpu")[0])


def _gpu_present():
    import jax
    return jax.devices()[0].platform == "gpu"


def _ours_baseml(model, seqfile, treefile, device="cpu", **kw):
    """device='cpu': classic all-f64 on the host (comparable to the C
    reference).  device='gpu': the production staged policy — f32 stage
    and f64 polish, both on the GPU (optim.maximize_policy)."""
    _setup_jax()
    import jax
    import jax.numpy as jnp
    from paml_tpu.apps import baseml
    t0 = time.perf_counter()
    spec = baseml.BasemlSpec(model=model, cleandata=True, **kw)
    if device == "gpu":
        res = baseml.fit(f"{REF}/{seqfile}", f"{REF}/{treefile}", spec)
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()   # warm: persistent compile cache hit
        res = baseml.fit(f"{REF}/{seqfile}", f"{REF}/{treefile}", spec)
        return dict(wall_s=round(time.perf_counter() - t0, 2),
                    wall_cold_s=round(cold, 2),
                    lnL=round(res.lnL, 6), n_eval=res.fit.n_eval)
    else:
        with _cpu():
            res = baseml.fit(f"{REF}/{seqfile}", f"{REF}/{treefile}",
                             spec, dtype=jnp.float64)
    return dict(wall_s=round(time.perf_counter() - t0, 2),
                lnL=round(res.lnL, 6), n_eval=res.fit.n_eval)


def _ours_codeml(seqfile, treefile, tree_index=0, device="cpu", **kw):
    _setup_jax()
    import jax
    import jax.numpy as jnp
    from paml_tpu.apps import codeml
    from paml_tpu.core.topology import from_treenode
    from paml_tpu.io import seqio, treeio
    t0 = time.perf_counter()
    aln = seqio.read_alignment(f"{REF}/{seqfile}", 1)
    data = seqio.pack(aln, cleandata=True, icode=kw.pop("icode", 0))
    trees = treeio.read_trees(f"{REF}/{treefile}", data.names)
    topo = from_treenode(trees[tree_index], data.names)
    spec = codeml.CodemlSpec(cleandata=True, **kw)
    if device == "gpu":
        res = codeml.fit_packed(data, topo, spec)
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()   # warm: persistent compile cache hit
        res = codeml.fit_packed(data, topo, spec)
        return dict(wall_s=round(time.perf_counter() - t0, 2),
                    wall_cold_s=round(cold, 2),
                    lnL=round(res.lnL, 6), n_eval=res.fit.n_eval)
    else:
        with _cpu():
            res = codeml.fit_packed(data, topo, spec,
                                    dtype=jnp.float64)
    return dict(wall_s=round(time.perf_counter() - t0, 2),
                lnL=round(res.lnL, 6), n_eval=res.fit.n_eval)


def _ref_run(prog, ctl_text, grab="lnL"):
    if not os.path.exists(f"{REFBIN}/{prog}"):
        return None
    with tempfile.TemporaryDirectory() as d:
        with open(f"{d}/run.ctl", "w") as f:
            f.write(ctl_text)
        t0 = time.perf_counter()
        try:
            subprocess.run([f"{REFBIN}/{prog}", "run.ctl"], cwd=d,
                           stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL, timeout=3600,
                           check=True)
        except Exception as e:
            return dict(error=str(e))
        wall = time.perf_counter() - t0
        outf = ("mlc" if prog == "codeml" else "mlb")
        lnl = None
        try:
            for line in open(f"{d}/{outf}"):
                if line.startswith("lnL"):
                    lnl = float(line.split(":")[-1].split()[0])
                    break
        except OSError:
            pass
        return dict(wall_s=round(wall, 2), lnL=lnl)


BASEML_CTL = """seqfile = {seq}
treefile = {tree}
outfile = mlb
noisy = 0
runmode = 0
model = {model}
Mgene = 0
clock = 0
fix_kappa = 0
kappa = 5
fix_alpha = {fix_alpha}
alpha = {alpha}
ncatG = {ncatG}
nparK = 0
nhomo = 0
getSE = 0
RateAncestor = 0
Small_Diff = 7e-6
cleandata = 1
method = 0
"""

CODEML_CTL = """seqfile = {seq}
treefile = {tree}
outfile = mlc
noisy = 0
runmode = 0
seqtype = 1
CodonFreq = 2
clock = 0
model = {model}
NSsites = {nssites}
icode = 0
fix_kappa = 0
kappa = 2
fix_omega = 0
omega = .4
fix_alpha = 1
alpha = 0
ncatG = {ncatG}
getSE = 0
RateAncestor = 0
Small_Diff = .5e-6
cleandata = 1
method = 0
"""


def main():
    # 8 virtual CPU devices for the mesh-scaling rows (must be set before
    # the first jax import initializes the backend)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    with_ref = "--no-reference" not in sys.argv
    out = {}

    gpu = _gpu_present()

    # 1. brown JC69 + K80
    for m, mi in (("JC69", 0), ("K80", 1)):
        row = {"ours": _ours_baseml(m, "brown.nuc", "brown.trees")}
        if gpu:
            row["ours_gpu"] = _ours_baseml(m, "brown.nuc", "brown.trees",
                                           device="gpu")
        if with_ref:
            row["reference"] = _ref_run("baseml", BASEML_CTL.format(
                seq=f"{REF}/brown.nuc", tree=f"{REF}/brown.trees",
                model=mi, fix_alpha=1, alpha=0, ncatG=1))
        out[f"baseml_{m}_brown"] = row
        print(f"baseml {m} brown: {row}", flush=True)

    # 2. horai GTR + G5
    row = {"ours": _ours_baseml("REV", "horai.nuc", "horai.trees",
                                fix_alpha=False, alpha=0.5, ncatG=5)}
    if gpu:
        row["ours_gpu"] = _ours_baseml("REV", "horai.nuc", "horai.trees",
                                       fix_alpha=False, alpha=0.5,
                                       ncatG=5, device="gpu")
    if with_ref:
        row["reference"] = _ref_run("baseml", BASEML_CTL.format(
            seq=f"{REF}/horai.nuc", tree=f"{REF}/horai.trees",
            model=7, fix_alpha=0, alpha=0.5, ncatG=5))
    out["baseml_GTRG5_horai"] = row
    print(f"baseml GTR+G5 horai: {row}", flush=True)

    # 3. abglobin codon M0
    row = {"ours": _ours_codeml("abglobin.nuc", "abglobin.trees")}
    if gpu:
        row["ours_gpu"] = _ours_codeml("abglobin.nuc", "abglobin.trees",
                                       device="gpu")
    if with_ref:
        row["reference"] = _ref_run("codeml", CODEML_CTL.format(
            seq=f"{REF}/abglobin.nuc", tree=f"{REF}/abglobin.trees",
            model=0, nssites=0, ncatG=3))
    out["codeml_M0_abglobin"] = row
    print(f"codeml M0 abglobin: {row}", flush=True)

    # 4. lysozyme NSsites suite + branch-site A
    for ns, ncatg, name in ((1, 3, "M1a"), (2, 3, "M2a"),
                            (7, 10, "M7"), (8, 10, "M8")):
        row = {"ours": _ours_codeml("lysozyme/lysozymeSmall.txt",
                                    "lysozyme/lysozymeSmall.trees",
                                    NSsites=ns, ncatG=ncatg, omega=0.5)}
        if gpu:
            row["ours_gpu"] = _ours_codeml(
                "lysozyme/lysozymeSmall.txt",
                "lysozyme/lysozymeSmall.trees",
                NSsites=ns, ncatG=ncatg, omega=0.5, device="gpu")
        if with_ref:
            row["reference"] = _ref_run("codeml", CODEML_CTL.format(
                seq=f"{REF}/lysozyme/lysozymeSmall.txt",
                tree=f"{REF}/lysozyme/lysozymeSmall.trees",
                model=0, nssites=ns, ncatG=ncatg))
        out[f"codeml_{name}_lysozyme"] = row
        print(f"codeml {name} lysozyme: {row}", flush=True)
    row = {"ours": _ours_codeml("lysozyme/lysozymeSmall.txt",
                                "lysozyme/lysozymeSmall.trees",
                                tree_index=1, model=2, NSsites=2,
                                omega=1.5)}
    if gpu:
        row["ours_gpu"] = _ours_codeml(
            "lysozyme/lysozymeSmall.txt", "lysozyme/lysozymeSmall.trees",
            tree_index=1, model=2, NSsites=2, omega=1.5, device="gpu")
    if with_ref:
        # the reference needs a tree file holding only the labeled tree
        from paml_tpu.io import treeio as _tio
        lines = open(f"{REF}/lysozyme/lysozymeSmall.trees").read()
        trees_txt = [t[t.index("("):] + ";" for t in lines.split(";")
                     if "(" in t]
        with tempfile.NamedTemporaryFile("w", suffix=".trees",
                                         delete=False) as tf:
            tf.write(" 7 1\n" + trees_txt[1] + "\n")
            tpath = tf.name
        row["reference"] = _ref_run("codeml", CODEML_CTL.format(
            seq=f"{REF}/lysozyme/lysozymeSmall.txt",
            tree=tpath, model=2, nssites=2, ncatG=3))
        os.unlink(tpath)
    out["codeml_branchsiteA_lysozyme"] = row
    print(f"codeml branch-site A lysozyme: {row}", flush=True)

    # 5. DatingSoftBound approximate-likelihood dating throughput
    _setup_jax()
    from paml_tpu.io import ctl as ctlmod
    from paml_tpu.apps.mcmctree import run_ctl
    src = f"{REF}/DatingSoftBound"
    with tempfile.TemporaryDirectory() as d:
        text = open(f"{src}/mcmctree.ctl").read()
        text = text.replace("= mtCDNApri123.txt",
                            f"= {src}/mtCDNApri123.txt")
        text = text.replace("= mtCDNApri.trees",
                            f"= {src}/mtCDNApri.trees")
        ctl = f"{d}/mcmctree.ctl"
        open(ctl, "w").write(text)
        cwd = os.getcwd()
        os.chdir(d)
        try:
            import jax as _jax
            opts = ctlmod.read_ctl(ctl)
            opts["usedata"] = "2"
            opts["burnin"] = "500"
            opts["nsample"] = "2000"
            opts["sampfreq"] = "2"
            t0 = time.perf_counter()
            with _jax.default_device(_jax.devices("cpu")[0]):
                run_ctl(opts, ctl, progress=False)
            wall = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        its = 500 + 2 * 2000
        out["mcmctree_approx_DatingSoftBound"] = {
            "ours": dict(wall_s=round(wall, 2),
                         iterations=its,
                         it_per_s=round(its / wall, 2))}
        if with_ref and os.path.exists(f"{REFBIN}/mcmctree"):
            # reference comparison (VERDICT r4 item 10): usedata=3 run
            # generates out.BV (its own per-locus baseml fits), then a
            # timed usedata=2 chain with the same burnin/sampfreq/nsample
            rd = os.path.join(d, "refrun")
            os.makedirs(rd, exist_ok=True)
            rtext = (open(f"{src}/mcmctree.ctl").read()
                     .replace("= mtCDNApri123.txt",
                              f"= {src}/mtCDNApri123.txt")
                     .replace("= mtCDNApri.trees",
                              f"= {src}/mtCDNApri.trees"))
            import re as _re
            rtext = _re.sub(r"usedata\s*=\s*\d", "usedata = 3", rtext)
            open(f"{rd}/run.ctl", "w").write(rtext)
            env = dict(os.environ,
                       PATH=f"{REFBIN}:" + os.environ.get("PATH", ""))
            try:
                subprocess.run([f"{REFBIN}/mcmctree", "run.ctl"], cwd=rd,
                               stdout=subprocess.DEVNULL,
                               stderr=subprocess.DEVNULL, timeout=1800,
                               check=True, env=env)
                shutil.copy(f"{rd}/out.BV", f"{rd}/in.BV")
                rtext2 = _re.sub(r"usedata\s*=\s*\d", "usedata = 2",
                                 rtext)
                rtext2 = _re.sub(r"burnin\s*=\s*\d+", "burnin = 500",
                                 rtext2)
                rtext2 = _re.sub(r"sampfreq\s*=\s*\d+", "sampfreq = 2",
                                 rtext2)
                rtext2 = _re.sub(r"nsample\s*=\s*\d+",
                                 "nsample = 2000", rtext2)
                open(f"{rd}/run.ctl", "w").write(rtext2)
                t0 = time.perf_counter()
                subprocess.run([f"{REFBIN}/mcmctree", "run.ctl"], cwd=rd,
                               stdout=subprocess.DEVNULL,
                               stderr=subprocess.DEVNULL, timeout=3600,
                               check=True, env=env)
                rwall = time.perf_counter() - t0
                out["mcmctree_approx_DatingSoftBound"]["reference"] = \
                    dict(wall_s=round(rwall, 2), iterations=its,
                         it_per_s=round(its / rwall, 2))
            except Exception as e:
                out["mcmctree_approx_DatingSoftBound"]["reference"] = \
                    dict(error=str(e)[:200])
        print("mcmctree approx DatingSoftBound:",
              out["mcmctree_approx_DatingSoftBound"], flush=True)

    # 6. HIVNSsites NSsites batch 0 1 2 through the ctl front end
    _setup_jax()
    from paml_tpu.__main__ import run_codeml as _run_codeml_cli
    with tempfile.TemporaryDirectory() as d:
        cwd = os.getcwd()
        os.chdir(d)
        try:
            t0 = time.perf_counter()
            _run_codeml_cli(f"{REF}/HIVNSsites/codeml.ctl")
            wall = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
    row = {"ours": dict(wall_s=round(wall, 2),
                        note="M0+M1a+M2a batch via ctl")}
    if with_ref:
        r = _ref_run("codeml", open(f"{REF}/HIVNSsites/codeml.ctl").read()
                     .replace("= HIVenvSweden.txt",
                              f"= {REF}/HIVNSsites/HIVenvSweden.txt")
                     .replace("= HIVenvSweden.trees",
                              f"= {REF}/HIVNSsites/HIVenvSweden.trees"))
        row["reference"] = r
    out["codeml_NSsites_batch_HIVNSsites"] = row
    print(f"codeml NSsites batch HIV: {row}", flush=True)

    # 7. MouseLemurs local-clock dating (Yoder & Yang 2003): F84+G5,
    # clock 3 combined analysis
    row = {"ours": _ours_baseml("F84", "MouseLemurs/MouseLemurs.nuc",
                                "MouseLemurs/MouseLemurs.trees",
                                clock=3, fix_alpha=False, alpha=0.5,
                                ncatG=5, kappa=2.3)}
    if gpu:
        row["ours_gpu"] = _ours_baseml(
            "F84", "MouseLemurs/MouseLemurs.nuc",
            "MouseLemurs/MouseLemurs.trees", clock=3, fix_alpha=False,
            alpha=0.5, ncatG=5, kappa=2.3, device="gpu")
    if with_ref:
        row["reference"] = _ref_run("baseml", BASEML_CTL.format(
            seq=f"{REF}/MouseLemurs/MouseLemurs.nuc",
            tree=f"{REF}/MouseLemurs/MouseLemurs.trees",
            model=3, fix_alpha=0, alpha=0.5, ncatG=5)
            .replace("clock = 0", "clock = 3"))
    out["baseml_clock3_MouseLemurs"] = row
    print(f"baseml clock3 MouseLemurs: {row}", flush=True)

    # 8. virtual-mesh scaling curve: sharded objective eval throughput on
    # 1/2/4/8 CPU virtual devices.  CPU vdevs share host cores, so this
    # measures partitioning overhead (plumbing), not speedup — the real
    # scaling needs several GPUs (shard_map over the pattern mesh)
    out["vdev_scaling"] = _vdev_scaling()
    print(f"vdev scaling: {out['vdev_scaling']}", flush=True)

    with open("BENCH_EXAMPLES.json", "w") as f:
        json.dump(out, f, indent=1)
    print("wrote BENCH_EXAMPLES.json")


def _vdev_scaling():
    """Jitted sharded codon objective (value+grad) wall time per eval at
    mesh sizes 1/2/4/8 (virtual CPU devices)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from paml_tpu.apps import codeml
    from paml_tpu.core.topology import from_treenode
    from paml_tpu.io import seqio, treeio
    from paml_tpu.parallel.sharding import data_mesh, replicate, shard_data

    aln = seqio.read_alignment(f"{REF}/abglobin.nuc", 1)
    data = seqio.pack(aln, cleandata=True, icode=0)
    topo = from_treenode(
        treeio.read_trees(f"{REF}/abglobin.trees", data.names)[0],
        data.names)
    spec = codeml.CodemlSpec(cleandata=True, NSsites=3, ncatG=3)
    neg, *_rest = codeml.make_codon_objective(data, topo, spec)
    x = jnp.asarray(_rest[2])
    devs = jax.devices("cpu")
    rows = {}
    for nd in (1, 2, 4, 8):
        if len(devs) < nd:
            break
        mesh = data_mesh(devs[:nd])
        tips_s, fpatt_s = shard_data(mesh, data.tip_partials, data.fpatt)
        xs = replicate(mesh, x)
        step = jax.jit(jax.value_and_grad(
            lambda p, t, f: neg.with_data(p, t, f)))
        with mesh:
            v, g = step(xs, tips_s, fpatt_s)
            jax.block_until_ready(v)
            t0 = time.perf_counter()
            for _ in range(5):
                v, g = step(xs, tips_s, fpatt_s)
            jax.block_until_ready(v)
            dt = (time.perf_counter() - t0) / 5
        rows[f"mesh_{nd}"] = dict(ms_per_eval=round(dt * 1e3, 2),
                                  lnL=round(-float(v), 6))
    return rows


if __name__ == "__main__":
    main()
