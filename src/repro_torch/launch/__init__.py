"""Step functions and entry points (the reference's ``repro.launch``):
meshes of workers, the training and serving steps, the device-steps
trainer and the train and serve CLIs, the dry-run with its cost analysis
and roofline.

Import ``repro_torch.launch.dryrun`` only where it is wanted: it plans
under a fake process group (``dryrun.fake_world``), which a caller joins
by running a combo, never by importing the package.  The reference's
``hlo_analysis`` is ``cost_analysis`` here.
"""
from repro_torch.launch import cost_analysis, mesh, roofline, steps  # noqa: F401
