"""Device-mesh sharding of the likelihood over site patterns.

The reference is single-threaded (SURVEY.md section 2.3); every parallel
axis here is new design.  The scaling model: the site-pattern axis is pure
data parallelism (per-pattern likelihoods are independent; the only
cross-pattern operation is the final fpatt-weighted reduction), so we lay
patterns out across a 1-D "data" mesh axis, replicate parameters, and let
XLA turn the final reduction into a psum, which it hands to NCCL.  The
GPUs of one host are joined all to all by NVLink, so the mesh follows
the algorithm alone.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def data_mesh(devices=None, axis: str = "data") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def pad_patterns(tip_partials: np.ndarray, fpatt: np.ndarray, n_shards: int):
    """Pad the pattern axis to a multiple of the mesh size.  Padding
    patterns get all-ones tip partials (positive site likelihood) and zero
    weight, so they contribute exactly nothing to lnL."""
    H = tip_partials.shape[1]
    Hpad = (-H) % n_shards
    if Hpad == 0:
        return tip_partials, fpatt
    ns, _, n = tip_partials.shape
    tp = np.concatenate(
        [tip_partials, np.ones((ns, Hpad, n), tip_partials.dtype)], axis=1)
    fp = np.concatenate([fpatt, np.zeros(Hpad, fpatt.dtype)])
    return tp, fp


def shard_data(mesh: Mesh, tip_partials, fpatt, axis: str = "data"):
    """Place (tips [ns, H, n], fpatt [H]) with H sharded over the mesh."""
    tp, fp = pad_patterns(np.asarray(tip_partials), np.asarray(fpatt),
                          int(np.prod(mesh.devices.shape)))
    s_tips = NamedSharding(mesh, P(None, axis, None))
    s_f = NamedSharding(mesh, P(axis))
    return jax.device_put(jnp.asarray(tp), s_tips), \
        jax.device_put(jnp.asarray(fp), s_f)


def replicate(mesh: Mesh, tree):
    s = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(jnp.asarray(x), s), tree)


def shard_data_multihost(mesh: Mesh, tip_partials, fpatt,
                         axis: str = "data"):
    """Multi-host variant of shard_data: every process holds the FULL
    arrays (each host reads the same alignment) and contributes only its
    slice of the pattern axis to the global jax.Array
    (jax.make_array_from_process_local_data).  Verified: 2-process lnL ==
    single-process lnL to all printed digits (tests/test_multihost.py).
    """
    nproc, pid = jax.process_count(), jax.process_index()
    nsh = int(np.prod(mesh.devices.shape))
    tp, fp = pad_patterns(np.asarray(tip_partials), np.asarray(fpatt), nsh)
    H = tp.shape[1]
    lo, hi = pid * H // nproc, (pid + 1) * H // nproc
    s_tips = NamedSharding(mesh, P(None, axis, None)
                           if tp.ndim == 3 else P(None, axis))
    s_f = NamedSharding(mesh, P(axis))
    tips_g = jax.make_array_from_process_local_data(s_tips, tp[:, lo:hi])
    fp_g = jax.make_array_from_process_local_data(s_f, fp[lo:hi])
    return tips_g, fp_g


# --- production auto-sharding ------------------------------------------------

def engage_auto_mesh(min_devices: int = 2, axis: str = "data"):
    """Engage the global pattern mesh over every local device when more
    than one is attached (the codeml/baseml CLI calls this).  Returns the
    Mesh or None.  Pass through to pruning.set_pattern_mesh(None) to
    disable."""
    devs = jax.devices()
    if len(devs) < min_devices:
        return None
    from ..core import pruning
    mesh = data_mesh(devs, axis)
    pruning.set_pattern_mesh(mesh, axis)
    return mesh


def pad_packed(data, n_shards: int):
    """Return a copy of a PackedData with the pattern axis padded to a
    multiple of n_shards (all-ones partials, zero weight — contributes
    exactly nothing to lnL), so the shard_map path engages."""
    import dataclasses
    H = data.tip_partials.shape[1]
    Hpad = (-H) % n_shards
    if Hpad == 0:
        return data
    tp, fp = pad_patterns(data.tip_partials, data.fpatt, n_shards)
    kw = dict(tip_partials=tp, fpatt=fp)
    if data.pos_masks is not None:
        ns = data.pos_masks.shape[0]
        pm = np.concatenate(
            [data.pos_masks,
             np.ones((ns, Hpad) + data.pos_masks.shape[2:],
                     data.pos_masks.dtype)], axis=1)
        kw["pos_masks"] = pm
    if data.pattern_site is not None:
        kw["pattern_site"] = np.concatenate(
            [data.pattern_site, np.zeros(Hpad, data.pattern_site.dtype)])
    return dataclasses.replace(data, **kw)


def maybe_pad_packed(data):
    """Pad a PackedData for the engaged pattern mesh (no-op when no mesh
    is engaged, the pattern count already divides the mesh, or the data
    is multi-gene — gene blocks are contiguous pattern ranges that
    padding at the tail would corrupt)."""
    from ..core import pruning
    pm = pruning._pattern_mesh
    if pm is None or data.ngene > 1:
        return data
    nsh = int(np.prod(pm[0].devices.shape))
    return pad_packed(data, nsh)
