"""Checks that need the GPU (marker ``chip``). They skip on the CPU, where
the suite runs; on the card, ``python chip_smoke.py`` runs the drivers' main
path with its comparisons."""
import pytest


@pytest.mark.chip
def test_single_run_on_the_card():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU; on the card run `python chip_smoke.py`")
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke

    chip_smoke.phase_integrate()
