"""Step builders (port of ``repro.launch``): the train step and the
serving steps on one device.  Sharding plans, meshes and the dry-run wait
for the multi-device and launch-analysis slices."""
