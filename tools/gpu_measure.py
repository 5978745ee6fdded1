"""GPU measurements of the likelihood paths and of the fit policy.

  python tools/gpu_measure.py [split] [tf32] [policy]   (default: all)

Needs a GPU (exits non-zero otherwise).  Prints, after the card's name
and power limit (nvidia-smi):

1. per bench shape, f32 value+grad of the full codon objective: the
   32 x 4,096 x 61 x 3 level path (M3, ladder tree) and the 1,024 x 10,240
   x 61 x 4 branch-site A wide path.  Milliseconds per evaluation split
   into P(t) (model_at alone), forward (value minus P(t)) and adjoint
   (value+grad minus value); from a jax.profiler trace of a steady window,
   device kernels per evaluation, device busy time per evaluation and the
   idle share; achieved bytes/s of a partial-traffic model against the
   card's 3.35 TB/s (NVIDIA H100 SXM data sheet).
2. TF32: the f32 lnL at matmul precision default / high / highest against
   f64, at the 32 x 4,096 shape.
3. fit policy: the staged fit (f32 stage, f64 polish) against the plain
   all-f64 fit, both on the GPU, on the chip_smoke codeml data, in the
   order staged, f64, f64, staged for each model.

The traffic model counts the partials the pruning recursion has to move
at least once per value+grad: forward writes every internal node's scaled
partial [C, n, H] and the adjoint reads it back, and the adjoint writes
and reads one [C, n, H] adjoint per internal node.
"""
from __future__ import annotations

import argparse
import glob
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from paml_tpu.apps import codeml  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory bandwidth


def device_trace_stats(step, args, n_evals, tdir):
    """Trace n_evals back-to-back calls; return (kernels per eval, busy
    ms per eval, idle share of the device span, host ms per eval)."""
    jax.block_until_ready(step(*args))
    with jax.profiler.trace(tdir):
        t0 = time.perf_counter()
        for _ in range(n_evals):
            out = step(*args)
        jax.block_until_ready(out)
        host_ms = (time.perf_counter() - t0) / n_evals * 1e3
    pb = sorted(glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                          recursive=True))[-1]
    pd = jax.profiler.ProfileData.from_file(pb)
    dev = [p for p in pd.planes if p.name.startswith("/device:GPU:0")]
    if not dev:
        raise RuntimeError("no /device:GPU:0 plane in the trace: "
                           + ", ".join(p.name for p in pd.planes))
    lines = list(dev[0].lines)
    print("    trace lines: " + ", ".join(
        f"{ln.name}[{len(list(ln.events))}]" for ln in lines), flush=True)
    streams = [ln for ln in lines if ln.name.startswith("Stream")] or [
        ln for ln in lines if ln.name not in ("XLA Modules", "XLA Ops",
                                              "Steps", "Source")]
    events = [e for ln in streams for e in ln.events]
    iv = sorted((e.start_ns, e.end_ns) for e in events)
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.duration_ns
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    total = sum(by_name.values()) or 1.0
    print("    top kernels (share of kernel time): " + "; ".join(
        f"{k[:60]} {v / total:.3f}" for k, v in top), flush=True)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    span = (iv[-1][1] - iv[0][0]) if iv else 0.0
    return (len(iv) / n_evals, busy / n_evals / 1e6,
            1.0 - busy / span if span else float("nan"), host_ms)


def measure_shape(label, topo, make, x0, tips, fpatt, C, tdir,
                  chunk_options=(1, 2, 4, 5, 8, 10, 16, 20)):
    dev = jax.devices()[0]
    x = jax.device_put(np.asarray(x0, np.float32), dev)
    t = jax.device_put(tips, dev)
    f = jax.device_put(np.asarray(fpatt, np.float32), dev)

    def make_vg(k):
        neg = make(jnp.float32, n_chunks=k)[0]
        return jax.value_and_grad(lambda x_, t_, f_: neg.with_data(x_, t_, f_))
    k, vg = cs.compile_fitting(make_vg, (x, t, f), dev, chunk_options)
    neg = make(jnp.float32, n_chunks=k)[0]
    val = jax.jit(neg.with_data)
    model = jax.jit(lambda x_: jax.tree.map(jnp.sum, neg.model_at(x_)))
    reps = 10 if tips.shape[0] < 256 else 3
    ms_vg, _ = cs.time_call(vg, x, t, f, reps=reps)
    ms_val, _ = cs.time_call(val, x, t, f, reps=reps)
    ms_model, _ = cs.time_call(model, x, reps=reps)
    kern, busy_ms, idle, host_ms = device_trace_stats(vg, (x, t, f), reps,
                                                     tdir)
    n, H = 61, tips.shape[1]
    n_int = topo.n_internal
    bytes_min = 4 * n_int * C * n * H * 4
    bw = bytes_min / (busy_ms / 1e3)
    stats = dev.memory_stats() or {}
    print(f"  {label}: n_chunks={k}  value+grad {ms_vg:.3f} ms = P(t) "
          f"{ms_model:.3f} + forward {ms_val - ms_model:.3f} + adjoint "
          f"{ms_vg - ms_val:.3f}", flush=True)
    print(f"    trace: {kern:.0f} device kernels/eval  busy {busy_ms:.3f} "
          f"ms/eval  idle share {idle:.3f}  host {host_ms:.3f} ms/eval",
          flush=True)
    print(f"    traffic model {bytes_min / 1e9:.3f} GB/eval -> "
          f"{bw / 1e12:.3f} TB/s = {bw / HBM_BYTES_PER_S:.3f} of 3.35 TB/s"
          f"  peak_bytes_in_use={stats.get('peak_bytes_in_use')}",
          flush=True)


def measure_tf32(ns=32, npatt=4096, seed=31):
    nwk, names = cs.ladder_tree(ns, seed)
    spec = codeml.CodemlSpec(NSsites=3, ncatG=3, codonf="Fequal",
                             cleandata=True)
    topo, make, x0, tips, fpatt = cs.codon_problem(nwk, names, spec,
                                                   npatt, seed)
    f64 = float(jax.jit(make(jnp.float64)[0].with_data)(
        jnp.asarray(x0), tips, jnp.asarray(fpatt)))
    neg32 = make(jnp.float32)[0]
    for prec in ("default", "high", "highest"):
        with jax.default_matmul_precision(prec):
            fn = jax.jit(neg32.with_data)
            args = (jnp.asarray(x0, jnp.float32), tips,
                    jnp.asarray(fpatt, jnp.float32))
            ms, v = cs.time_call(fn, *args, reps=10)
        print(f"  f32 lnL at matmul precision {prec:8s}: {-float(v):.6f}  "
              f"f64 {-f64:.6f}  rel {cs.rel(v, f64):.3e}  "
              f"value {ms:.3f} ms", flush=True)


def measure_policy(workdir, ns=32, ncodon=1000, seed=11):
    cs.simulate_codon_alignment(workdir, ns, ncodon, seed)
    data, topo = cs._dataset(workdir, cs.seqio.CODON_SEQ)
    ctl = _write_ctl(workdir)
    spec = cs.ctlmod.codeml_spec(cs.ctlmod.read_ctl(ctl), ctl)[0]
    policies = (("staged f32+f64", None), ("all-f64", jnp.float64))
    for k in (0, 1, 2):
        sp = cs.dataclasses.replace(spec, NSsites=k)
        # ABBA order: the first fit of each model also pays compilation
        for name, dtype in policies + policies[::-1]:
            t0 = time.perf_counter()
            res = codeml.fit_packed(data, topo, sp, dtype=dtype)
            print(f"  NSsites={k} {name:15s}: lnL {res.lnL:.6f}  "
                  f"{res.fit.n_eval} evaluations  "
                  f"{time.perf_counter() - t0:.2f} s (compile included)",
                  flush=True)


def _write_ctl(workdir):
    path = os.path.join(workdir, "codeml.ctl")
    with open(path, "w") as f:
        f.write(cs.CODEML_CTL)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parts", nargs="*", choices=("split", "tf32", "policy"),
                    help="measurements to run (default: all)")
    parts = ap.parse_args(argv).parts or ("split", "tf32", "policy")
    cs.phase_device(1)
    if "split" in parts:
        os.makedirs(cs.WORKDIR, exist_ok=True)
        tdir = tempfile.mkdtemp(dir=cs.WORKDIR)
        print("1. per-shape split (f32 value+grad of the full objective)",
              flush=True)
        nwk, names = cs.ladder_tree(32, 31)
        spec = codeml.CodemlSpec(NSsites=3, ncatG=3, codonf="Fequal",
                                 cleandata=True)
        measure_shape("32 x 4096 x 61 x 3 level", *cs.codon_problem(
            nwk, names, spec, 4096, 31), C=3,
            tdir=os.path.join(tdir, "level"))
        with jax.default_device(jax.devices()[0]):
            prob = cs.big_problem(1024, 10240, 41)
        measure_shape("1024 x 10240 x 61 x 4 wide", *prob, C=4,
                      tdir=os.path.join(tdir, "wide"))
        shutil.rmtree(tdir)
    if "tf32" in parts:
        print("2. TF32 cost at 32 x 4096 x 61 x 3", flush=True)
        measure_tf32()
    if "policy" in parts:
        print("3. fit policy on the chip_smoke codeml data", flush=True)
        measure_policy(os.path.join(cs.WORKDIR, "policy"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
