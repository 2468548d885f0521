"""The render-gradient comparison of test_torch_port_render_grad.py for
two more option sets: secondary edges alone, and a backward with its own
sample count (num_samples=(2, 4)).  A file of its own so that its JAX
compiles run on another worker."""

import pytest

from tests.test_torch_port_render_grad import check_render_gradients
from tests.torch_port_util import two_torch_threads  # noqa: F401


@pytest.mark.parametrize("case", ["secondary_only", "spp_2_4"])
def test_render_gradients_match_jax(case):
    check_render_gradients(case)
