"""The port's package version is the reference's."""

import redner_tpu
import redner_tpu_torch


def test_version_matches_the_reference():
    assert redner_tpu_torch.__version__ == redner_tpu.__version__ == "0.1.0"
