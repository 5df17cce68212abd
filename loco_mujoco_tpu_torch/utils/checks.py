"""Task-string validation: the JAX package's `utils/checks.py` (reference
`loco_mujoco/utils/checks.py` and `ValidTaskConf`, reference
base.py:972-1041), plain Python."""

from __future__ import annotations


class ValidTaskConf:
    """Validates environment configurations (tasks / modes / dataset types
    and non-combinable tuples)."""

    def __init__(self, tasks=None, modes=None, data_types=None, non_combinable=None):
        self.tasks = tasks
        self.modes = modes
        self.data_types = data_types
        self.non_combinable = non_combinable
        if non_combinable is not None:
            for nc in non_combinable:
                assert len(nc) == 3

    def get_all(self):
        return (
            list(self.tasks) if self.tasks else None,
            list(self.modes) if self.modes else None,
            list(self.data_types) if self.data_types else None,
            list(self.non_combinable) if self.non_combinable else None,
        )

    def get_all_combinations(self):
        """All valid (task, mode, dataset_type) dicts (base.py:994-1041)."""
        combos = []
        tasks = self.tasks if self.tasks else [None]
        modes = self.modes if self.modes else [None]
        dts = self.data_types if self.data_types else [None]
        for t in tasks:
            for m in modes:
                for dt in dts:
                    conf = dict()
                    if t is not None:
                        conf["task"] = t
                    if m is not None:
                        conf["mode"] = m
                    if dt is not None:
                        conf["dataset_type"] = dt
                    if self.non_combinable:
                        ok = True
                        for nc_t, nc_m, nc_dt in self.non_combinable:
                            if (
                                (nc_t is None or t == nc_t)
                                and (nc_m is None or m == nc_m)
                                and (nc_dt is None or dt == nc_dt)
                            ):
                                ok = False
                        if not ok:
                            continue
                    combos.append(conf)
        return combos


def check_validity_task_mode_dataset(
    env_name,
    task=None,
    mode=None,
    dataset_type=None,
    valid_tasks=None,
    valid_modes=None,
    valid_dataset_types=None,
    non_combinable=None,
):
    """Raises ValueError with a helpful message on invalid configurations
    (reference checks.py:3-76)."""

    def fail(what, got, valid):
        raise ValueError(
            f"Invalid {what} {got!r} for environment {env_name}. "
            f"Valid options: {valid}."
        )

    if task is not None and valid_tasks is not None and task not in valid_tasks:
        fail("task", task, valid_tasks)
    if mode is not None and valid_modes is not None and mode not in valid_modes:
        fail("mode", mode, valid_modes)
    if (
        dataset_type is not None
        and valid_dataset_types is not None
        and dataset_type not in valid_dataset_types
    ):
        fail("dataset_type", dataset_type, valid_dataset_types)
    if non_combinable is not None:
        for nc_t, nc_m, nc_dt in non_combinable:
            if (
                (nc_t is None or task == nc_t)
                and (nc_m is None or mode == nc_m)
                and (nc_dt is None or dataset_type == nc_dt)
            ):
                raise ValueError(
                    f"The combination task={task!r} mode={mode!r} "
                    f"dataset_type={dataset_type!r} is not valid for "
                    f"environment {env_name}."
                )
    return True
