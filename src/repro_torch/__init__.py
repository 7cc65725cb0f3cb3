"""PyTorch/CUDA port of the ``repro`` DSDPS control loop for NVIDIA Hopper.

Module names mirror ``repro``'s (``repro/core/ddpg.py`` ↔
``repro_torch/core/ddpg.py``).  The package imports torch, numpy and scipy
only.  Every per-lane tensor carries the fleet axis as its leading ``[F]``
dimension; a single run is ``F=1``."""
