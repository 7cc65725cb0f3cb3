"""``run_online_agent`` against the reference's for every agent of the
placement family, on Jamba-1.5-large's 16 experts on 16 devices (the
scheduling family's cases are in test_torch_single_run.py, whose helpers
this file shares)."""
import pytest

from test_torch_single_run import PLACEMENT, check_run_online_agent, envs  # noqa: F401


@pytest.mark.parametrize("name", PLACEMENT)
def test_run_online_agent_matches_reference_on_placement(envs, name):  # noqa: F811
    check_run_online_agent(envs, "placement", name)
