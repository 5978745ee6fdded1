"""Benchmark: site-pattern likelihood evals/sec on one GPU (61-state codon).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "extra": {...}}
with the GPU's device_kind and power limit (nvidia-smi) in `extra`.
Exits non-zero when JAX's default device is not a GPU.

Primary workload: jitted value+gradient of an NSsites M3 codon
log-likelihood (the optimizer inner loop) — 32 taxa (ladder tree, the
deepest schedule), 4,096 site patterns simulated by the evolver, 61
states, 3 site classes, float32.  Steps run back-to-back inside one jit
(lax.scan); per-step Python dispatch is reported beside it.

`extra` adds the model_at share of a step (Q build + P(t)) and the
1,024-taxon x 10,240-pattern branch-site A (4-class) value+grad, with the
pattern axis split into the fewest chunks that fit device memory.

Baseline: the reference codeml evaluates `lfun` (value only; its gradients
cost extra finite-difference evals).  Measured single-core C (-O3): M2a on
HIVenvSweden = 1660 lfun evals in 17 s with 23 branches x 3 classes x 79
patterns -> 5.32e5 branch-class-pattern partial updates/sec.  vs_baseline
is the ratio of update throughput (ours counts the gradient as part of
the same eval).
"""
import json

import chip_smoke as cs

import jax
import jax.numpy as jnp
import numpy as np

from paml_tpu.apps import codeml

REF_UPDATES_PER_SEC = 5.32e5     # reference codeml, measured (see docstring)

NS_TAXA = 32
NPATT = 4096
K_CLASSES = 3                    # NSsites=3 (M3) with ncatG=3

BIG_TAXA = 1024
BIG_NPATT = 10240


def _time_steps_fused(neg_lnl, x, args, n_iter=30, reps=3):
    """Back-to-back value+grad steps inside ONE jit (lax.scan), with no
    host dispatch between evaluations."""
    xs = x[None, :] + 1e-6 * jnp.arange(n_iter, dtype=x.dtype)[:, None]

    @jax.jit
    def run(xs, *a):
        def body(c, xi):
            v, g = jax.value_and_grad(neg_lnl)(xi, *a)
            return c + v + jnp.sum(g) * 1e-30, None
        tot, _ = jax.lax.scan(body, jnp.asarray(0.0, x.dtype), xs)
        return tot

    ms, out = cs.time_call(run, xs, *args, reps=reps)
    if not bool(jnp.isfinite(out)):
        raise RuntimeError("non-finite benchmark loss")
    return ms / n_iter


def main():
    dev = cs.phase_device(1)[0]
    card = cs.nvidia_smi().splitlines()[0]

    nwk, names = cs.ladder_tree(NS_TAXA, 1)
    spec = codeml.CodemlSpec(NSsites=3, ncatG=3, codonf="Fequal",
                             cleandata=True)
    _, make, x0, tips, fpatt = cs.codon_problem(nwk, names, spec, NPATT, 1)
    neg = make(jnp.float32)[0]
    x = jnp.asarray(x0, jnp.float32)
    args = (jnp.asarray(tips), jnp.asarray(fpatt, jnp.float32))
    step = jax.jit(jax.value_and_grad(neg.with_data))
    dispatch_ms, _ = cs.time_call(step, x, *args, reps=30)
    dt_ms = _time_steps_fused(neg.with_data, x, args)
    model = jax.jit(lambda x_: jax.tree.map(jnp.sum, neg.model_at(x_)))
    model_ms, _ = cs.time_call(model, x, reps=30)

    evals_per_sec = 1e3 / dt_ms
    nbranch = 2 * NS_TAXA - 2
    updates_per_sec = evals_per_sec * NPATT * nbranch * K_CLASSES

    with jax.default_device(dev):
        _, bmake, bx0, btips, bfpatt = cs.big_problem(BIG_TAXA, BIG_NPATT,
                                                      7)
    bargs = (jax.device_put(np.asarray(bx0, np.float32), dev),
             jax.device_put(btips, dev),
             jax.device_put(np.asarray(bfpatt, np.float32), dev))

    def make_step(k):
        bneg = bmake(jnp.float32, n_chunks=k)[0]
        return jax.value_and_grad(lambda x_, t_, f_: bneg.with_data(
            x_, t_, f_))
    k, big_step = cs.compile_fitting(make_step, bargs, dev,
                                     (1, 2, 4, 5, 8, 10, 16, 20))
    big_ms, _ = cs.time_call(big_step, *bargs, reps=3)
    print(json.dumps({
        "metric": "codon61_sitepattern_lnl+grad_evals_per_sec",
        "value": evals_per_sec * NPATT,
        "unit": "site-pattern-evals/s",
        "vs_baseline": updates_per_sec / REF_UPDATES_PER_SEC,
        "extra": {
            "device_kind": dev.device_kind,
            "nvidia_smi_name_power_limit": card,
            "primary_ms_per_eval": dt_ms,
            "primary_ms_per_eval_with_dispatch": dispatch_ms,
            "model_at_ms": model_ms,
            "big_shape": f"{BIG_TAXA} taxa x {BIG_NPATT} patterns "
                         f"branch-site A",
            "big_n_chunks": k,
            "big_ms_per_eval": big_ms,
            "big_pattern_evals_per_sec": BIG_NPATT / big_ms * 1e3,
        },
    }))


if __name__ == "__main__":
    main()
