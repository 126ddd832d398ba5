"""Step functions and entry points (the reference's ``repro.launch``):
meshes of workers, the training and serving steps, the device-steps
trainer and the train and serve CLIs."""
