# Twins of the reference's examples/: quickstart.py, scenario_fleet.py,
# expert_placement.py, serve_lm.py and train_lm.py, each run as
# ``python -m repro_torch.examples.<name>`` with the reference's flags and
# ``--device``; each keeps its budget in a ``run(...)`` whose defaults are
# the reference's.  drl_storm_control.py's twin is figures/storm_control.py.
