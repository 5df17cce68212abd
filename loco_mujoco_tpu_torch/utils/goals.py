"""Goal containers (the JAX package's `utils/goals.py`, reference
utils/goals.py:4-28).

The batched envs carry goals as tensors of `EnvState` (`state.goal`); this
mutable container is the host-side API for user code that drives goals
imperatively (interactive play, replay).
"""

from copy import deepcopy


class GoalDirectionVelocity:
    """Mutable (direction, velocity) goal pair."""

    def __init__(self):
        self._direction = None
        self._velocity = None

    def __call__(self):
        return self.get_goal()

    def get_goal(self):
        assert self._direction is not None
        assert self._velocity is not None
        return deepcopy(self._direction), deepcopy(self._velocity)

    def set_goal(self, direction, velocity):
        self._direction = direction
        self._velocity = velocity

    def get_direction(self):
        assert self._direction is not None
        return deepcopy(self._direction)

    def get_velocity(self):
        assert self._velocity is not None
        return deepcopy(self._velocity)
