"""The fixed-base tests of test_torch_kernels.py (K1, K2 and their stage)
again at a 4096-bit modulus, the width of a 2048-bit key's n^2 (k = 304
lanes, the kernels' full width).  A file of its own so that pytest-xdist's
``--dist loadfile`` runs this slow set-up beside the 256-bit one, not after
it; the tests and their names are those of test_torch_kernels.py."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_kernels import (  # noqa: E402,F401  (collected here again)
    _fb_setup,
    _one_torch_thread,
    fb_exps,
    test_fb_modexp2_matches_pallas_and_pow,
    test_fb_modexp2_ragged_batch,
    test_fb_table2_entries_match_pow,
    test_fb_table2_matches_pallas,
    test_fb_table_stage_matches_reference_planes,
    test_fb_wrappers_reject_wrong_inputs,
    test_launch_counters_untouched_on_cpu,
)


@pytest.fixture(scope="module", params=[4096])
def fb256(request):
    return _fb_setup(request.param)
