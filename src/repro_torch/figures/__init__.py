"""The paper's evaluation: twins of ``benchmarks/paper_*.py`` (Figs 6-12)
and of ``examples/drl_storm_control.py``, each run as ``python -m
repro_torch.figures.<name>`` and writing its JSON under ``ART``
(``artifacts/torch/paper/``)."""
