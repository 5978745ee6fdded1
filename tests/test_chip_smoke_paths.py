"""chip_smoke.py's likelihood-path phases at tiny sizes on the CPU,
including the four-device phase on virtual CPU devices."""
import jax

import conftest  # noqa: F401
import chip_smoke
from paml_tpu.core import pruning


def test_phase_level_tiny():
    out = chip_smoke.phase_level(ns=6, npatt=32)
    assert set(out) == {"float64", "float32"}


def test_phase_wide_tiny():
    out = chip_smoke.phase_wide(ns=164, npatt=64, nslice=16,
                                chunk_options=(1,))
    assert out["float32"]["n_chunks"] == 1


def test_phase_four_tiny(tmp_path):
    chip_smoke.phase_four(str(tmp_path), jax.devices()[:4], ns=5,
                          ncodon=30, big_ns=164, big_npatt=64)
    assert pruning._pattern_mesh is None
