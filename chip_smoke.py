"""Smoke test of paml_tpu on NVIDIA GPUs: the quickest proof that the
program still starts and computes right on the card.

  python chip_smoke.py               # phases 0-3 on one GPU
  python chip_smoke.py --four-gpus   # phase 4 only, on four GPUs

All data are simulated from fixed seeds by the repo's own evolver.  Every
result is checked against the plain float64 reference
(paml_tpu/core/plain_pruning.py), evaluated on the host CPU unless stated.

  0. device: the default JAX device must be a GPU; prints its kind, the
     JAX version, XLA_FLAGS and nvidia-smi's name and power limit.
  1. codeml CLI: M0, M1a, M2a (NSsites = 0 1 2) on 32 taxa x 1,000 codons
     simulated under M2a; each fitted lnL against the reference at the
     fitted MLE, and the M2a - M1a likelihood-ratio statistic.
  2. baseml CLI: REV+G5 on 32 taxa x 5,000 sites, same check.
  3. the pruning paths at bench widths, value + gradient on the GPU:
     32 x 4,096 x 61 x 3 (level path) in f64 and f32, and 1,024 x 10,240
     x 61 x 4 branch-site A (wide path) in f32 against f64.
  4. (--four-gpus only) the phase-1 fit with the pattern mesh over four
     GPUs against one GPU, and the big shape sharded over four GPUs
     against one.

Any failed check exits non-zero.  The last line of standard output is
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
and is printed only when every phase passed.
"""
from __future__ import annotations

import os

# the CPU backend hosts the reference evaluations beside the GPU
_plat = os.environ.get("JAX_PLATFORMS", "")
if _plat and "cpu" not in _plat.split(","):
    os.environ["JAX_PLATFORMS"] = _plat + ",cpu"

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from paml_tpu.__main__ import main as cli_main  # noqa: E402
from paml_tpu.__main__ import run_codeml  # noqa: E402
from paml_tpu.apps import baseml, codeml, evolver  # noqa: E402
from paml_tpu.core import plain_pruning, pruning  # noqa: E402
from paml_tpu.core.simulate import simulate_states  # noqa: E402
from paml_tpu.core.topology import from_treenode  # noqa: E402
from paml_tpu.io import ctl as ctlmod  # noqa: E402
from paml_tpu.io import seqio, treeio  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
# simulated data and CLI outputs (listed in .gitignore)
WORKDIR = os.path.join(REPO, ".chip_smoke")

# Tolerances (relative unless stated) and why:
# the CLI prints lnL to 1e-6 and the MLE x to 1e-6 (rst1); at an optimum
# the lnL is flat in x, so the reference at the printed x agrees to ~1e-9.
TOL_CLI_LNL = 1e-8
TOL_LRT = 0.01                 # absolute, on 2*delta lnL (SURVEY.md s.7)
# f64 on both sides: only summation order differs (cuBLAS vs CPU).
TOL_F64_LNL = 1e-10
TOL_F64_GRAD = 1e-8
# f32 with Precision.HIGHEST: the repo's f32 parity bar (SURVEY.md s.7);
# gradients are differences of large f32 terms, hence the looser bar.
TOL_F32_LNL = 1e-5
TOL_F32_GRAD = 1e-3
# the same f32 program sharded over devices: only reduction order differs.
TOL_SHARD_LNL = 1e-6


class CheckFailed(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    print(("  ok    " if ok else "  FAIL  ") + what, flush=True)
    if not ok:
        raise CheckFailed(what)


def rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-300)


def rel_maxnorm(a, b) -> float:
    a = np.concatenate([np.ravel(np.asarray(x, np.float64)) for x in a])
    b = np.concatenate([np.ravel(np.asarray(x, np.float64)) for x in b])
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@contextlib.contextmanager
def in_dir(path: str):
    os.makedirs(path, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(path)
    try:
        yield path
    finally:
        os.chdir(cwd)


class _Tee(io.TextIOBase):
    """Copy writes to a buffer and to the real stdout."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def run_cli(argv, keep_mesh=False) -> str:
    """Run the command line in-process; return what it printed.  The CLI
    engages a pattern mesh over every device; unless keep_mesh, it is
    released afterwards."""
    tee = _Tee(sys.stdout)
    try:
        with contextlib.redirect_stdout(tee):
            cli_main(argv)
    finally:
        if not keep_mesh:
            pruning.set_pattern_mesh(None)
    return tee.buf.getvalue()


def cpu_device():
    return jax.devices("cpu")[0]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def random_unrooted_tree(ns: int, seed: int, blen=(0.02, 0.12)) -> str:
    """Newick of a random unrooted binary tree (trifurcating root) with
    uniform branch lengths."""
    rng = np.random.default_rng(seed)
    pool = [f"s{i + 1}" for i in range(ns)]

    def bl():
        return f"{rng.uniform(*blen):.5f}"
    while len(pool) > 3:
        i, j = sorted(rng.choice(len(pool), 2, replace=False))
        b = pool.pop(j)
        a = pool.pop(i)
        pool.append(f"({a}: {bl()}, {b}: {bl()})")
    return "(" + ", ".join(f"{p}: {bl()}" for p in pool) + ");"


def balanced_tree(ns: int, seed: int, blen=(0.01, 0.06),
                  foreground_half=False) -> tuple[str, list[str]]:
    """Newick of a balanced rooted tree; with foreground_half the first
    half of the taxa is labelled #1 (branch-site foreground)."""
    rng = np.random.default_rng(seed)
    names = [f"t{i}" for i in range(ns)]

    def bal(lo, hi):
        if hi - lo == 1:
            s = names[lo]
        else:
            m = (lo + hi) // 2
            s = f"({bal(lo, m)},{bal(m, hi)})"
        return f"{s}:{rng.uniform(*blen):.5f}"
    h = ns // 2
    left = bal(0, h) + (" #1" if foreground_half else "")
    return f"({left},{bal(h, ns)});", names


def ladder_tree(ns: int, seed: int, blen=(0.02, 0.12)):
    rng = np.random.default_rng(seed)
    names = [f"t{i}" for i in range(ns)]
    nwk = f"{names[0]}:{rng.uniform(*blen):.5f}"
    for nm in names[1:]:
        nwk = f"({nwk},{nm}:{rng.uniform(*blen):.5f}):{rng.uniform(*blen):.5f}"
    return nwk + ";", names


def simulate_codon_alignment(workdir, ns: int, ncodon: int, seed: int):
    """M2a data via the evolver: 60 % of sites at omega 0.1, 30 % at 1,
    10 % at 2.5; kappa 2; equal codon frequencies.  Writes mc.paml and
    tree.nwk in workdir."""
    tree = random_unrooted_tree(ns, seed)
    freqs = "\n".join(" ".join(["0.015625"] * 4) for _ in range(16))
    with in_dir(workdir):
        with open("MCcodon.dat", "w") as f:
            f.write(f"0\n{seed}\n{ns} {ncodon} 1\n-1\n{tree}\n"
                    f"3\n0.6 0.3 0.1\n0.1 1.0 2.5\n2.0\n{freqs}\n0\n")
        evolver.simulate_codon("MCcodon.dat", "mc.paml", seed=seed)
        with open("tree.nwk", "w") as f:
            f.write(tree + "\n")


def simulate_nuc_alignment(workdir, ns: int, nsite: int, seed: int):
    """REV+G5 data via the evolver (alpha 0.5).  Writes mc.paml and
    tree.nwk in workdir."""
    tree = random_unrooted_tree(ns, seed)
    with in_dir(workdir):
        with open("MCbase.dat", "w") as f:
            f.write(f"0\n{seed}\n{ns} {nsite} 1\n-1\n{tree}\n7\n"
                    f"2.0 0.5 0.6 0.4 0.7\n0.5 5\n0.3 0.2 0.25 0.25\n")
        evolver.simulate_nuc("MCbase.dat", "mc.paml", seed=seed)
        with open("tree.nwk", "w") as f:
            f.write(tree + "\n")


CODEML_CTL = """seqfile = mc.paml
treefile = tree.nwk
outfile = mlc
noisy = 0
verbose = 0
runmode = 0
seqtype = 1
CodonFreq = 2
clock = 0
model = 0
NSsites = 0 1 2
icode = 0
fix_kappa = 0
kappa = 2
fix_omega = 0
omega = 0.4
cleandata = 1
"""

BASEML_CTL = """seqfile = mc.paml
treefile = tree.nwk
outfile = mlb
noisy = 0
verbose = 0
runmode = 0
model = 7
Mgene = 0
clock = 0
fix_kappa = 0
kappa = 2
fix_alpha = 0
alpha = 0.5
Malpha = 0
ncatG = 5
fix_rho = 1
rho = 0
nparK = 0
getSE = 0
RateAncestor = 0
cleandata = 1
"""


def _read(path) -> str:
    with open(path) as f:
        return f.read()


def _read_rst1(path):
    return [np.array([float(v) for v in line.split()])
            for line in _read(path).splitlines() if line.strip()]


def _fit_notes(stdout: str):
    """[(evaluations, seconds)] per fit from the CLI's progress lines."""
    return [(int(n), float(s)) for n, s in
            re.findall(r"\((\d+) evaluations, ([\d.]+) s\)", stdout)]


def _dataset(workdir, seqtype):
    data = seqio.pack(seqio.read_alignment(
        os.path.join(workdir, "mc.paml"), seqtype), cleandata=True)
    topo = from_treenode(treeio.read_trees(
        os.path.join(workdir, "tree.nwk"), data.names)[0], data.names)
    return data, topo


# ---------------------------------------------------------------------------
# phase 1: codeml CLI
# ---------------------------------------------------------------------------


def codeml_cli_fit(workdir, keep_mesh=False, one_device=False):
    """Run the phase-1 ctl through the CLI in workdir (with one_device,
    through run_codeml with no pattern mesh); returns ({NSsites: lnL from
    mlc}, {NSsites: x from rst1}, stdout)."""
    with in_dir(workdir):
        with open("codeml.ctl", "w") as f:
            f.write(CODEML_CTL)
        if one_device:
            run_codeml("codeml.ctl")
            out = ""
        else:
            out = run_cli(["codeml", "codeml.ctl"], keep_mesh)
        mlc = _read("mlc")
        rst1 = _read_rst1("rst1")
    lnls = {int(k): float(v) for k, v in re.findall(
        r"Model NSsites=(\d+)\s+TREE # 1\nlnL\(ntime:\s*\d+\s+np:\s*\d+\):"
        r"\s*(-?\d+\.\d+)", mlc)}
    xs = dict(zip(sorted(lnls), (r[1:] for r in rst1)))
    return lnls, xs, out


def phase_codeml(workdir, ns=32, ncodon=1000, seed=11):
    print(f"phase 1: codeml CLI, M0/M1a/M2a, {ns} taxa x {ncodon} codons "
          f"simulated under M2a", flush=True)
    simulate_codon_alignment(workdir, ns, ncodon, seed)
    t0 = time.perf_counter()
    lnls, xs, out = codeml_cli_fit(workdir)
    wall = time.perf_counter() - t0
    notes = _fit_notes(out)
    check(sorted(lnls) == [0, 1, 2] and len(notes) == 3,
          f"mlc holds M0, M1a and M2a ({sorted(lnls)})")
    opts = ctlmod.read_ctl(os.path.join(workdir, "codeml.ctl"))
    spec = ctlmod.codeml_spec(opts, os.path.join(workdir, "codeml.ctl"))[0]
    refs = {}
    with jax.default_device(cpu_device()):
        data, topo = _dataset(workdir, seqio.CODON_SEQ)
        for k in (0, 1, 2):
            sp = dataclasses.replace(spec, NSsites=k)
            neg = codeml.make_codon_objective(data, topo, sp,
                                              jnp.float64)[0]
            P, piC, w = neg.model_at(jnp.asarray(xs[k]))
            refs[k] = float(plain_pruning.lnL(P, data.tip_partials, topo,
                                              piC, w, data.fpatt))
    for k, (nev, sec) in zip((0, 1, 2), notes):
        print(f"  NSsites={k}: lnL {lnls[k]:.6f}  reference {refs[k]:.6f}"
              f"  rel {rel(lnls[k], refs[k]):.3e}  {nev} evaluations"
              f"  {sec:.2f} s", flush=True)
        check(rel(lnls[k], refs[k]) <= TOL_CLI_LNL,
              f"NSsites={k} lnL matches the reference to {TOL_CLI_LNL}")
    lrt, lrt_ref = 2 * (lnls[2] - lnls[1]), 2 * (refs[2] - refs[1])
    print(f"  2(lnL M2a - lnL M1a) = {lrt:.6f}, reference {lrt_ref:.6f}",
          flush=True)
    check(abs(lrt - lrt_ref) <= TOL_LRT,
          f"M2a-M1a LRT statistic within {TOL_LRT}")
    print(f"  phase 1 wall {wall:.1f} s", flush=True)
    return lnls


# ---------------------------------------------------------------------------
# phase 2: baseml CLI
# ---------------------------------------------------------------------------


def phase_baseml(workdir, ns=32, nsite=5000, seed=21):
    print(f"phase 2: baseml CLI, REV+G5, {ns} taxa x {nsite} sites",
          flush=True)
    simulate_nuc_alignment(workdir, ns, nsite, seed)
    t0 = time.perf_counter()
    with in_dir(workdir):
        with open("baseml.ctl", "w") as f:
            f.write(BASEML_CTL)
        out = run_cli(["baseml", "baseml.ctl"])
        mlb = _read("mlb")
        x = _read_rst1("rst1")[0][1:]
    wall = time.perf_counter() - t0
    lnl = float(re.search(r"TREE # 1\nlnL\(ntime:\s*\d+\s+np:\s*\d+\):"
                          r"\s*(-?\d+\.\d+)", mlb).group(1))
    (nev, sec), = _fit_notes(out)
    opts = ctlmod.read_ctl(os.path.join(workdir, "baseml.ctl"))
    spec = ctlmod.baseml_spec(opts, os.path.join(workdir, "baseml.ctl"))[0]
    with jax.default_device(cpu_device()):
        data, topo = _dataset(workdir, seqio.BASE_SEQ)
        neg = baseml.make_objective(data, topo, spec)[0]
        P, piC, w, _ = neg.model_at(jnp.asarray(x))
        ref = float(plain_pruning.lnL(P, data.tip_partials, topo, piC, w,
                                      data.fpatt))
    print(f"  REV+G5: lnL {lnl:.6f}  reference {ref:.6f}  rel "
          f"{rel(lnl, ref):.3e}  {nev} evaluations  {sec:.2f} s", flush=True)
    check(rel(lnl, ref) <= TOL_CLI_LNL,
          f"REV+G5 lnL matches the reference to {TOL_CLI_LNL}")
    print(f"  phase 2 wall {wall:.1f} s", flush=True)
    return lnl


# ---------------------------------------------------------------------------
# phase 3: the pruning paths at bench widths
# ---------------------------------------------------------------------------


def codon_problem(nwk, names, spec, npatt, seed):
    """(topo, objective maker, x0, tips [ns, npatt], fpatt): sites
    simulated by the evolver core under the model at x0 (each site its
    own pattern).  Equal codon frequencies, so the model does not depend
    on the data."""
    topo = from_treenode(treeio.parse_newick(nwk), names)
    ns, n = len(names), 61
    onehot = np.zeros((ns, 1, n))
    onehot[:, 0, 0] = 1.0
    dummy = seqio.PackedData(names=names, seqtype=1, nstates=n,
                             tip_partials=onehot, fpatt=np.ones(1), ls=1,
                             posG=np.array([0, 1]),
                             base_freqs=np.full(n, 1 / n))

    def make(dtype, n_chunks=1):
        return codeml.make_codon_objective(dummy, topo, spec, dtype,
                                           n_chunks=n_chunks)
    neg64, _, _, x0, _, _ = make(jnp.float64)
    P, piC, w = neg64.model_at(jnp.asarray(x0))
    states, _ = simulate_states(jax.random.PRNGKey(seed), topo, P, piC[0],
                                npatt, w)
    tips = np.asarray(states[:ns], np.int32)
    return topo, make, np.asarray(x0), tips, np.ones(npatt)


def time_call(f, *args, reps=3):
    jax.block_until_ready(f(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = f(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3, out


def phase_level(ns=32, npatt=4096, seed=31, device=None):
    """32 taxa (ladder, the deepest tree) x npatt x 61 states x 3 classes
    (M3): the level path, value + gradient w.r.t. (P, pi), f64 and f32."""
    device = device or jax.devices()[0]
    print(f"phase 3a: level path, {ns} x {npatt} x 61 x 3, value+grad "
          f"on {device.platform}", flush=True)
    nwk, names = ladder_tree(ns, seed)
    spec = codeml.CodemlSpec(NSsites=3, ncatG=3, codonf="Fequal",
                             cleandata=True)
    with jax.default_device(cpu_device()):
        topo, make, x0, tips, fpatt = codon_problem(nwk, names, spec,
                                                    npatt, seed)
        P, piC, w = make(jnp.float64)[0].model_at(jnp.asarray(x0))
        vg_ref = jax.jit(jax.value_and_grad(
            lambda P_, pi_: plain_pruning.lnL(P_, tips, topo, pi_, w, fpatt),
            argnums=(0, 1)))
        v_ref, g_ref = vg_ref(P, piC)
    check(topo.nnode <= pruning._WIDE_NNODE
          and len(pruning._levels(topo)) <= pruning._MAX_UNROLL,
          f"{ns}-taxon ladder takes the level path")
    vg = jax.jit(jax.value_and_grad(
        lambda P_, pi_, t_, w_, f_: pruning.lnL(P_, t_, topo, pi_, w_, f_),
        argnums=(0, 1)))
    out = {}
    for dt, tol_v, tol_g in ((jnp.float64, TOL_F64_LNL, TOL_F64_GRAD),
                             (jnp.float32, TOL_F32_LNL, TOL_F32_GRAD)):
        args = [jax.device_put(np.asarray(a, dt), device)
                for a in (P, piC)] + [jax.device_put(tips, device)] + [
            jax.device_put(np.asarray(a, dt), device) for a in (w, fpatt)]
        ms, (v, g) = time_call(vg, *args)
        name = jnp.dtype(dt).name
        rv, rg = rel(v, v_ref), rel_maxnorm(g, g_ref)
        print(f"  {name}: lnL {float(v):.10f}  reference {float(v_ref):.10f}"
              f"  rel {rv:.3e}  grad rel {rg:.3e}  {ms:.3f} ms/value+grad",
              flush=True)
        check(rv <= tol_v, f"{name} lnL matches the reference to {tol_v}")
        check(rg <= tol_g, f"{name} gradient matches the reference to {tol_g}")
        out[name] = dict(ms=ms, rel=rv, grad_rel=rg)
    return out


def _memory_fields(ma) -> str:
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return "  ".join(f"{k}={getattr(ma, k, None)}" for k in keys)


def compile_fitting(make_step, args, device, chunk_options):
    """Compile make_step(n_chunks) for the smallest n_chunks whose
    program fits the device's free memory (memory_analysis against
    memory_stats), starting at 1.  Returns (n_chunks, compiled)."""
    stats = device.memory_stats() or {}
    free = stats.get("bytes_limit", 0) - stats.get("bytes_in_use", 0)
    for k in chunk_options:
        compiled = jax.jit(make_step(k)).lower(*args).compile()
        ma = compiled.memory_analysis()
        need = (ma.temp_size_in_bytes + ma.argument_size_in_bytes
                + ma.output_size_in_bytes) if ma is not None else 0
        if not stats or need <= 0.95 * free:
            return k, compiled
        print(f"  n_chunks={k} needs {need / 2**30:.1f} GiB of "
              f"{free / 2**30:.1f} GiB free: cut to more chunks", flush=True)
    raise CheckFailed(f"no n_chunks in {chunk_options} fits the device")


def big_problem(ns, npatt, seed):
    nwk, names = balanced_tree(ns, seed, foreground_half=True)
    spec = codeml.CodemlSpec(NSsites=2, model=2, codonf="Fequal",
                             cleandata=True, omega=1.5)
    return codon_problem(nwk, names, spec, npatt, seed)


def phase_wide(ns=1024, npatt=10240, nslice=1024, seed=41, device=None,
               chunk_options=(1, 2, 4, 5, 8, 10, 16, 20)):
    """1,024 taxa x 10,240 patterns x 61 states x 4 classes, branch-site
    A: the wide path.  Per-pattern lnf (f32, GPU) on a slice against the
    CPU reference; the full-width f32 gradient against the f64 gradient
    on the same device."""
    device = device or jax.devices()[0]
    print(f"phase 3b: wide path, {ns} x {npatt} x 61 x 4 branch-site A "
          f"on {device.platform}", flush=True)
    t0 = time.perf_counter()
    with jax.default_device(device):
        topo, make, x0, tips, fpatt = big_problem(ns, npatt, seed)
    print(f"  simulated in {time.perf_counter() - t0:.1f} s", flush=True)
    check(topo.nnode > pruning._WIDE_NNODE,
          f"{ns}-taxon tree takes the wide path")
    tips_d = jax.device_put(tips, device)
    x_d = {dt: jax.device_put(np.asarray(x0, dt), device)
           for dt in (jnp.float32, jnp.float64)}

    # per-pattern lnf on a slice, f32 on the device vs f64 on the CPU
    neg32 = make(jnp.float32)[0]
    lnf_fn = jax.jit(lambda x, t: _site_lnf(neg32, x, t, topo))
    lnf = np.asarray(lnf_fn(x_d[jnp.float32], tips_d[:, :nslice]))
    with jax.default_device(cpu_device()):
        P, piC, w = make(jnp.float64)[0].model_at(jnp.asarray(x0))
        lnf_ref = np.asarray(plain_pruning.site_loglik(
            P, tips[:, :nslice], topo, piC, w))
    r = float(np.max(np.abs(lnf - lnf_ref) / np.abs(lnf_ref)))
    print(f"  per-pattern lnf, {nslice}-pattern slice: max rel {r:.3e}",
          flush=True)
    check(r <= TOL_F32_LNL, f"f32 per-pattern lnf matches the reference "
          f"to {TOL_F32_LNL}")

    res = {}
    for dt in (jnp.float32, jnp.float64):
        name = jnp.dtype(dt).name
        f_d = jax.device_put(np.asarray(fpatt, dt), device)

        def make_step(k, dt=dt):
            neg = make(dt, n_chunks=k)[0]
            return jax.value_and_grad(
                lambda x, t, f: neg.with_data(x, t, f))
        args = (x_d[dt], tips_d, f_d)
        k, compiled = compile_fitting(make_step, args, device, chunk_options)
        ms, (v, g) = time_call(compiled, *args)
        stats = device.memory_stats() or {}
        print(f"  {name}: n_chunks={k}  lnL {-float(v):.6f}  "
              f"{ms:.1f} ms/value+grad  peak_bytes_in_use="
              f"{stats.get('peak_bytes_in_use')}", flush=True)
        print(f"    memory_analysis: "
              f"{_memory_fields(compiled.memory_analysis())}", flush=True)
        check(bool(np.isfinite(float(v))) and bool(np.all(np.isfinite(
            np.asarray(g)))), f"{name} value and gradient are finite")
        res[name] = dict(ms=ms, n_chunks=k, v=float(v), g=np.asarray(g))
    g32, g64 = res["float32"]["g"], res["float64"]["g"]
    rg = rel_maxnorm([g32], [g64])
    rv = rel(res["float32"]["v"], res["float64"]["v"])
    i = int(np.argmax(np.abs(g32 - g64)))
    print(f"  f32 vs f64 on the device: lnL rel {rv:.3e}  grad rel {rg:.3e}"
          f" (largest error at parameter {i} of {g64.size}: "
          f"{g32[i]:.6g} vs {g64[i]:.6g}; max |g| {np.max(np.abs(g64)):.6g})",
          flush=True)
    check(rv <= TOL_F32_LNL, f"f32 lnL matches f64 to {TOL_F32_LNL}")
    check(rg <= TOL_F32_GRAD, f"f32 gradient matches f64 to {TOL_F32_GRAD}")
    return res


def _site_lnf(neg, x, tips, topo):
    P, piC, w = neg.model_at(x)
    return pruning.site_loglik(P, tips, topo, piC, w)


# ---------------------------------------------------------------------------
# phase 4: four GPUs
# ---------------------------------------------------------------------------


def phase_four(workdir, devices, ns=32, ncodon=1000, big_ns=1024,
               big_npatt=10240, seed=11,
               chunk_options=(1, 2, 4, 5, 8, 10, 16, 20)):
    from jax.sharding import NamedSharding, PartitionSpec as PS

    from paml_tpu.parallel.sharding import data_mesh

    nd = len(devices)
    print(f"phase 4: {nd} devices ({devices[0].device_kind})", flush=True)
    # (a) the phase-1 ctl: CLI with the auto pattern mesh, then one device
    simulate_codon_alignment(workdir, ns, ncodon, seed)
    try:
        t0 = time.perf_counter()
        lnl_mesh, _, _ = codeml_cli_fit(workdir, keep_mesh=True)
        t_mesh = time.perf_counter() - t0
        mesh = pruning._pattern_mesh
        check(mesh is not None and mesh[0].devices.size == len(jax.devices()),
              "the CLI engaged a pattern mesh over every device")
    finally:
        pruning.set_pattern_mesh(None)
    one = os.path.join(workdir, "one_device")
    os.makedirs(one, exist_ok=True)
    for fn in ("mc.paml", "tree.nwk"):
        shutil.copy(os.path.join(workdir, fn), one)
    t0 = time.perf_counter()
    with jax.default_device(devices[0]):
        lnl_one, _, _ = codeml_cli_fit(one, one_device=True)
    t_one = time.perf_counter() - t0
    print(f"  CLI fit wall: mesh {t_mesh:.1f} s, one device {t_one:.1f} s",
          flush=True)
    for k in (0, 1, 2):
        print(f"  NSsites={k}: mesh {lnl_mesh[k]:.6f}  one device "
              f"{lnl_one[k]:.6f}  rel {rel(lnl_mesh[k], lnl_one[k]):.3e}",
              flush=True)
        check(rel(lnl_mesh[k], lnl_one[k]) <= TOL_SHARD_LNL,
              f"NSsites={k}: mesh and one-device lnL agree to "
              f"{TOL_SHARD_LNL}")

    # (b) the big shape sharded over the devices vs one device
    with jax.default_device(devices[0]):
        topo, make, x0, tips, fpatt = big_problem(big_ns, big_npatt, seed)
    x = np.asarray(x0, np.float32)
    fp = np.asarray(fpatt, np.float32)

    def make_step(k):
        neg = make(jnp.float32, n_chunks=k)[0]
        return jax.value_and_grad(lambda x_, t_, f_: neg.with_data(x_, t_, f_))

    args1 = tuple(jax.device_put(a, devices[0]) for a in (x, tips, fp))
    k1, c1 = compile_fitting(make_step, args1, devices[0], chunk_options)
    ms1, (v1, g1) = time_call(c1, *args1)
    mesh = data_mesh(devices)
    argsN = (jax.device_put(x, NamedSharding(mesh, PS())),
             jax.device_put(tips, NamedSharding(mesh, PS(None, "data"))),
             jax.device_put(fp, NamedSharding(mesh, PS("data"))))
    pruning.set_pattern_mesh(mesh)
    try:
        kN, cN = compile_fitting(make_step, argsN, devices[0], chunk_options)
        msN, (vN, gN) = time_call(cN, *argsN)
    finally:
        pruning.set_pattern_mesh(None)
    print(f"  one device: n_chunks={k1} {ms1:.1f} ms/value+grad; {nd} "
          f"devices: n_chunks={kN} {msN:.1f} ms/value+grad", flush=True)
    for s in argsN[1].addressable_shards:
        st = s.device.memory_stats() or {}
        print(f"  {s.device}: tips shard {s.data.shape} of {tips.shape}  "
              f"bytes_in_use={st.get('bytes_in_use')}  "
              f"peak_bytes_in_use={st.get('peak_bytes_in_use')}", flush=True)
    check(all(s.data.shape[1] * nd == tips.shape[1]
              for s in argsN[1].addressable_shards),
          f"each device holds 1/{nd} of the patterns")
    rv, rg = rel(vN, v1), rel_maxnorm([gN], [g1])
    print(f"  sharded vs one device: lnL rel {rv:.3e}  grad rel {rg:.3e}",
          flush=True)
    check(rv <= TOL_SHARD_LNL, f"sharded lnL matches one device to "
          f"{TOL_SHARD_LNL}")
    check(rg <= TOL_F32_GRAD, f"sharded gradient matches one device to "
          f"{TOL_F32_GRAD}")


# ---------------------------------------------------------------------------
# phase 0 and main
# ---------------------------------------------------------------------------


def phase_device(n_cards: int):
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: JAX's default device is "
                 f"{devs[0].platform}, not a GPU")
    if len(devs) < n_cards:
        sys.exit(f"chip_smoke: {n_cards} GPUs needed, {len(devs)} found")
    print(f"phase 0: {devs[0].device_kind} x {len(devs)}  jax "
          f"{jax.__version__}  XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}",
          flush=True)
    print(nvidia_smi(), flush=True)
    return devs


def nvidia_smi() -> str:
    """The cards' names and power limits, one line per card, read by a
    child process that does not use JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only phase 4, on four GPUs")
    args = ap.parse_args(argv)
    devs = phase_device(4 if args.four_gpus else 1)
    t0 = time.perf_counter()
    if args.four_gpus:
        phase_four(os.path.join(WORKDIR, "four"), devs[:4])
        count = 4
    else:
        phase_codeml(os.path.join(WORKDIR, "codeml"))
        phase_baseml(os.path.join(WORKDIR, "baseml"))
        phase_level()
        phase_wide()
        count = len(devs)
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
