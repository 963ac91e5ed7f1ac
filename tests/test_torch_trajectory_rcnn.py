"""Many training steps of the port against the JAX package's own: the rcnn
family with stage-2 offsets.

One arm of ``test_torch_trajectory.py`` (its docstring states the setup,
the draws and the bounds; its checks run here on this file's arm).
"""

import pytest

pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package imports flax

from test_torch_trajectory import (  # noqa: E402, F401  (the tree fixture and the shared checks)
    arm_fixture,
    test_clip_bites_where_set,
    test_learning_rate_decays_as_optax,
    test_losses_follow_jax_every_step,
    test_proposals_equal_every_step,
    test_state_matches_jax_after_k_steps,
    tree,
)

run = arm_fixture("offsets")
