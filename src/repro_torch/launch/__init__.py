"""Launchers of the port (twin of ``repro.launch``): the stage-to-device
map (:mod:`repro_torch.launch.mesh`) and the pipeline serving launcher
(:mod:`repro_torch.launch.serve`)."""
