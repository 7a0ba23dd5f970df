"""spectrobot_tpu — a line-by-line radiative-transfer and
optimal-estimation retrieval framework for GPUs.

Built from scratch against the capability surface of fedef17/SpectRobot
(SURVEY.md): HITRAN ingestion, Voigt/Humlicek line shapes, Curtis-Godson
layering, limb/nadir integration, non-LTE source functions, analytic
Jacobians and Levenberg-Marquardt retrievals — designed for JAX/XLA/Pallas on
GPU meshes rather than ported from the reference's NumPy/Fortran code.
"""

__version__ = "0.1.0"
