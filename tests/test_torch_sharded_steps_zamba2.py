"""The port's auto-mode steps over logical meshes against the JAX
package's steps for smoke zamba2_2p7b: the train step on (4, 2), (2, 2) and
(4, 1) against the reference's single-device step, and the serving steps
on (2, 2).  ``tests/test_torch_sharded_steps.py`` says what is compared
and why; this arch has a file (and a reference subprocess) of its own so
that no file of the group runs long (granite and olmoe there, xlstm in
``tests/test_torch_sharded_steps_xlstm.py``).
"""

import pytest

from torch_sharded_steps import (ONE_DEVICE_MESHES, check_serving_steps,
                                 check_train_step, run_reference)
from torch_threads import one_intra_op_thread  # noqa: F401

ARCHS = ("zamba2_2p7b",)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory, ARCHS)


@pytest.mark.parametrize("shape", ONE_DEVICE_MESHES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_reference(reference, arch, shape):
    check_train_step(reference, arch, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serving_steps_match_reference(reference, arch):
    check_serving_steps(reference, arch)
